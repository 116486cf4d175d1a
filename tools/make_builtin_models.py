#!/usr/bin/env python
"""Regenerate nanocall_tpu/models/builtin.npz from pore-model TSV files.

Equivalent of the reference's make-builtin-model-initializers
(src/builtin_models/): instead of embedding 49k lines of C++ initializer
lists, the model tables (ONT-provided data) are packed into one npz keyed
by model name, with a parallel strands array.

Usage: make_builtin_models.py OUT.npz STRAND:NAME:FILE [...]
e.g.   make_builtin_models.py builtin.npz 0:r73.t.006:/path/r73.t.006.ont.model ...
"""

import sys

import numpy as np

sys.path.insert(0, ".")
from nanocall_tpu import pore_model  # noqa: E402


def main():
    out = sys.argv[1]
    data, names, strands = {}, [], []
    for spec in sys.argv[2:]:
        strand, name, path = spec.split(":", 2)
        pm = pore_model.load_tsv(path, strand=int(strand), name=name)
        data[f"{name}.table"] = np.stack(
            [pm.level_mean, pm.level_stdv, pm.sd_mean, pm.sd_stdv]
        )
        names.append(name)
        strands.append(int(strand))
    data["names"] = np.array(names)
    data["strands"] = np.array(strands, dtype=np.int32)
    np.savez_compressed(out, **data)
    print(f"wrote {out}: {names}")


if __name__ == "__main__":
    main()
