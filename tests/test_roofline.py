"""Consistency tests for the MFU/roofline accounting (nanocall_tpu/roofline)."""

import numpy as np
import pytest

from nanocall_tpu import roofline

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_itemized_totals_consistent():
    for n in (64, 4096):
        fwd = roofline.grouped_forward_ops_per_event(n)
        assert fwd["total"] == sum(v for k, v in fwd.items() if k != "total")
        tb = roofline.grouped_traceback_ops_per_event(n)
        assert tb["total"] == sum(v for k, v in tb.items() if k != "total")
        dec = roofline.decode_ops_per_event(n)
        assert dec["total"] == fwd["total"] + tb["total"]


def test_ops_model_magnitude():
    """The K=6 production figure the bench uses: ~47 ops/state forward,
    ~3 ops/state traceback."""
    n = 4096
    fwd = roofline.grouped_forward_ops_per_event(n)["total"]
    assert 40 * n < fwd < 55 * n
    tb = roofline.grouped_traceback_ops_per_event(n)["total"]
    assert 3 * n <= tb < 4 * n


def test_em_itemized_totals_consistent():
    for n in (64, 4096):
        for fn in (
            roofline.fwbw_grouped_fwd_ops_per_event,
            roofline.fwbw_grouped_bwd_ops_per_event,
            roofline.em_scaling_mstep_ops_per_event,
            roofline.em_st_mstep_ops_per_event,
            roofline.em_hbm_bytes_per_event,
        ):
            d = fn(n)
            assert d["total"] == sum(
                v for k, v in d.items() if k != "total"), fn.__name__
        tot = roofline.em_ops_per_event(n)
        assert tot["total"] == (
            tot["fwd"] + tot["bwd"] + tot["scaling_mstep"] + tot["st_mstep"]
        )


def test_em_ops_model_magnitude():
    """K=6 production figures: E-step fwd ~37/state, bwd ~20/state; the
    transition M-step is the second-heaviest term (~56/state); 9 float32
    (B,T,n)-tensor passes of HBM traffic."""
    n = 4096
    fwd = roofline.fwbw_grouped_fwd_ops_per_event(n)["total"]
    assert 33 * n < fwd < 42 * n
    bwd = roofline.fwbw_grouped_bwd_ops_per_event(n)["total"]
    assert 16 * n < bwd < 24 * n
    st = roofline.em_st_mstep_ops_per_event(n)["total"]
    assert 45 * n < st < 65 * n
    assert roofline.em_hbm_bytes_per_event(n)["total"] == 9 * 4 * n
    # flags zero out the corresponding M-steps
    assert roofline.em_ops_per_event(n, train_scaling=False)[
        "scaling_mstep"] == 0
    assert roofline.em_ops_per_event(n, train_transitions=False)[
        "st_mstep"] == 0


def test_em_fused_models():
    for n in (64, 4096):
        for fn in (roofline.em_fused_bwd_ops_per_event,
                   roofline.em_fused_ops_per_event,
                   roofline.em_fused_hbm_bytes_per_event):
            d = fn(n)
            assert d["total"] == sum(
                v for k, v in d.items() if k not in ("total", "matmul_macs")
            ), fn.__name__
    n = 4096
    # fused round: ~127 ops/state (log-space st block), only 8n bytes
    # (alpha write + read) — the bytes ceiling rises ~4.5x over the
    # legacy 36n formulation
    tot = roofline.em_fused_ops_per_event(n)["total"]
    assert 120 * n < tot < 135 * n
    assert roofline.em_fused_hbm_bytes_per_event(n)["total"] == 8 * n
    rep_f = roofline.em_mfu_report(1.6e6, n, H100,
                                   fma_peak_ops_per_s=2.6e12)
    rep_l = roofline.em_mfu_report(1.6e6, n, H100,
                                   fma_peak_ops_per_s=2.6e12, fused=False)
    assert rep_f["ceiling_events_per_s_hbm"] > 4 * rep_l[
        "ceiling_events_per_s_hbm"]
    # fused is compute-bound (the point of the redesign)
    assert rep_f["binding_resource"] == "compute"


def test_em_mfu_report_fields_and_binding():
    n = 4096
    rep = roofline.em_mfu_report(1.5e6, n, H100, fma_peak_ops_per_s=3e12,
                                 fused=False)
    assert rep["achieved_ops_per_s"] == 1.5e6 * roofline.em_ops_per_event(
        n)["total"]
    assert rep["achieved_hbm_bytes_per_s"] == 1.5e6 * 9 * 4 * n
    assert rep["binding_resource"] in ("hbm", "compute")
    # at K=6 the legacy round moves 36n bytes (9 f32 tensor passes) and
    # does ~477k ops per event: with H100 HBM (3.35e12/147456 = 22.7M)
    # against a 3 Tops measured peak (3e12/477e3 = 6.3M) compute binds
    assert rep["ceiling_events_per_s_hbm"] == (
        H100["hbm_bytes_per_s"] / (9 * 4 * n))
    assert rep["ceiling_events_per_s_hbm"] > rep["ceiling_events_per_s_compute"]
    assert rep["binding_resource"] == "compute"


def test_fma_peak_runs_on_cpu():
    """The microbenchmark itself must run (tiny shape, CPU backend)."""
    peak, dt = roofline.measure_fma_peak(4, 256, T=32, k=4, n_iter=1)
    assert peak > 0 and dt > 0


def test_mfu_report_fields():
    rep = roofline.mfu_report(128, 8192, 4096, decode_s=0.16, peak=H100,
                              fma_peak_ops_per_s=1e13)
    assert rep["achieved_ops_per_s"] > 0
    assert 0 < rep["mfu_vs_measured_fma_peak"] < 10
    achieved = 128 * 8192 * roofline.decode_ops_per_event(4096)["total"] / 0.16
    assert np.isclose(rep["achieved_ops_per_s"], achieved)
    assert np.isclose(rep["mfu_vs_fp32_spec"], achieved / 67e12)


def test_peak_table_has_h100():
    """The H100 SXM row carries NVIDIA's data-sheet peaks and its source."""
    row = roofline.peak_for("NVIDIA H100 80GB HBM3")
    assert row["fp32_flops_per_s"] == 67e12
    assert row["tf32_flops_per_s"] == 495e12
    assert row["bf16_flops_per_s"] == 989e12
    assert row["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in row["source"]


def test_peak_table_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peak_for("cpu")
    with pytest.raises(ValueError):
        roofline.peak_for("NVIDIA H100 PCIe")
