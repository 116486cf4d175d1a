"""Test configuration: the CPU with 8 virtual devices for sharding tests.

The suite runs on the CPU whatever JAX_PLATFORMS says.  The tests marked
`gpu` also need the card: on a machine with one, run them as
`NANOCALL_TEST_GPU=1 python -m pytest -m gpu tests/`, which lets JAX see
the GPU beside the CPU; they skip where JAX then finds no GPU.
"""

import os

_platforms = "cuda,cpu" if os.environ.get("NANOCALL_TEST_GPU") == "1" else "cpu"
os.environ["JAX_PLATFORMS"] = _platforms
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)

# Reference-binary goldens are the core conformance evidence; never let
# them skip silently.  When the reference tree + a compiler are present,
# a failed/absent golden fixture FAILS the suite (golden_unavailable in
# ref_tools.py); elsewhere (e.g. GitHub CI, which has no /root/reference)
# the skips are counted and shouted in the terminal summary below.
import shutil  # noqa: E402

if (
    os.path.isdir("/root/reference/src/nanocall")
    and shutil.which("g++")
    and "NANOCALL_REQUIRE_GOLDENS" not in os.environ
):
    os.environ["NANOCALL_REQUIRE_GOLDENS"] = "1"


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    from ref_tools import GOLDEN_SKIP_TAG

    skips = terminalreporter.stats.get("skipped", [])
    n = sum(
        1
        for rep in skips
        if GOLDEN_SKIP_TAG in str(getattr(rep, "longrepr", ""))
    )
    if n:
        msg = (
            f"{n} reference-binary GOLDEN test(s) SKIPPED — this run proves "
            f"nothing about reference conformance (reference tree or "
            f"compiler unavailable)"
        )
        terminalreporter.write_sep("!", msg, yellow=True, bold=True)
        if os.environ.get("GITHUB_ACTIONS"):
            print(f"::warning title=golden tests skipped::{msg}")
