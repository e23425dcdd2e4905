"""The trajectory study (``pretraining_llm_tpu_torch/utils/trajectory.py``)
on the CPU at the tiny preset's size, fp32, with document masking on
``data/parity`` bytes. There the head x attention settings differ only in
summation order: same-state losses within 1e-5 and every gradient leaf
within 1e-5 relative of the twin's; the runs apart by less than 1e-4 over
three steps, the ulp-moved ones included.
"""

import math

import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu_torch.config import get_preset
from pretraining_llm_tpu_torch.utils import trajectory as tj


def _tiny(tmp_path):
    return get_preset("tiny").with_overrides({
        "train.eval_interval": 0, "train.checkpoint_interval": 0, "train.save_final": False,
        "train.checkpoint_dir": str(tmp_path), "model.doc_mask_token": 10, "model.compute_dtype": "float32",
        "data.train_path": str(tj.PARITY / "train.bin"), "data.val_path": str(tj.PARITY / "val.bin"),
    })


def test_study_settings_agree_at_fp32(tmp_path):
    steps = 3
    res = tj.study(_tiny(tmp_path), steps, "cpu")
    assert set(res["runs"]) == set(tj.SETTINGS)
    for recs in res["runs"].values():
        assert len(recs) == steps and all(math.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in recs)
    assert res["max_loss_diff_vs_twin"][tj.TWIN] == 0.0
    assert max(res["max_loss_diff_vs_twin"].values()) < 1e-4
    assert [r["step"] for r in res["same_state"]] == list(range(1, steps + 1))
    for rec in res["same_state"]:
        assert set(rec) == {"step", "twin_loss", "fused_flash", "fused_naive", "chunked_flash"}
        for name in ("fused_flash", "fused_naive", "chunked_flash"):
            assert abs(rec[name]["loss_diff"]) < 1e-5 and rec[name]["max_rel_grad_diff"] < 1e-5


def test_t3_config_is_chip_smokes_t3_run():
    cfg = tj.t3_config()
    m, t = cfg.model, cfg.train
    assert (m.n_layers, m.d_model, m.context_length, m.vocab_size, m.compute_dtype) == (12, 768, 1024, 50304,
                                                                                        "bfloat16")
    assert (m.doc_mask_token, t.batch_size, t.lr, t.train_steps, t.eval_interval) == (10, 12, 6e-4, 20, 0)
    assert t.warmup_frac * t.train_steps == 3


def test_same_state_measures_every_leaf_against_fp32(tmp_path):
    """At fp32 compute the twin is the fp32 reference itself: every leaf's
    twin_err is 0 and path_err is rel within rounding. At bf16 compute
    every leaf carries finite distances, the twin's from fp32 nonzero."""
    cfg = _tiny(tmp_path)
    for rec in tj.same_state(cfg, 2, "cpu", ["chunked_flash"]):
        per = rec["chunked_flash"]["leaves"]
        assert rec["chunked_flash"]["max_rel_grad_diff"] == max(u["rel"] for u in per.values()) < 1e-5
        for u in per.values():
            assert u["twin_err"] == 0.0 and u["path_err"] < 1e-5
    rec = tj.same_state(cfg.with_overrides({"model.compute_dtype": "bfloat16"}), 1, "cpu",
                        ["chunked_flash"])[0]["chunked_flash"]
    assert rec["leaf"] in rec["leaves"]
    for u in rec["leaves"].values():
        assert u["twin_err"] > 0.0 and all(math.isfinite(x) for x in u.values())


@pytest.mark.parametrize("leaf, want", [
    ({"rel": 0.02, "twin_err": 0.0, "path_err": 0.5}, "twin"),  # within the bar: held to the twin alone
    ({"rel": 0.021, "twin_err": 0.039, "path_err": 0.0}, None),  # over it, twin not far enough from fp32
    ({"rel": 0.5, "twin_err": 0.04, "path_err": 0.04}, "fp32"),  # twin off fp32, path no farther
    ({"rel": 0.5, "twin_err": 1.0, "path_err": 1.0001}, None),  # path farther from fp32 than the twin
    ({"rel": math.inf, "twin_err": 1.0, "path_err": math.inf}, None),  # a NaN path
    ({"rel": 0.5, "twin_err": math.inf, "path_err": 1.0}, None),  # a NaN twin is no excuse
])
def test_held_by(leaf, want):
    assert tj.held_by(leaf, 0.02, 0.04) == want


def test_repeat_compares_two_runs_bit_for_bit(tmp_path):
    """``repeat`` (the ``--repeat`` mode) trains the run twice and compares
    losses and grad norms bit for bit, and step 1's gradient leaves on the
    same params and batch. On the CPU every operation repeats exactly."""
    res = tj.repeat(_tiny(tmp_path), 2, "cpu")
    assert [r["step"] for r in res["steps"]] == [1, 2]
    assert all(r["loss"][0] == r["loss"][1] and r["grad_norm"][0] == r["grad_norm"][1] for r in res["steps"])
    assert res["losses_bit_identical"] and res["grad_norms_bit_identical"]
    assert res["first_differing_step"] is None and res["step1_grad_leaves_differing"] == []


def test_op_trace_measures_twin_and_path_against_fp32(tmp_path):
    """``op_trace`` (the ``--op-trace`` mode): at fp32 compute the twin is
    the fp32 reference, so every aligned op and gradient leaf is 0 apart and
    nothing passes the bar, and the fused/flash path's leaves are within
    rounding; at bf16 every distance of both is finite and the twin's
    nonzero, leaf for leaf under the same names."""
    res = tj.op_trace(_tiny(tmp_path), 2, "cpu")
    assert res["step"] == 2 and res["bar"] == tj.T3_GRAD_RTOL and res["n_aligned"] == res["n_ops_fp32"]
    assert res["first_forward_over"] is None and res["first_backward_over"] is None
    assert set(res["leaves"]) == set(res["path_leaves"])
    assert all(v == 0.0 for v in res["leaves"].values())
    assert max(res["path_leaves"].values()) < 1e-5
    res = tj.op_trace(_tiny(tmp_path).with_overrides({"model.compute_dtype": "bfloat16"}), 2, "cpu")
    assert set(res["leaves"]) == set(res["path_leaves"])
    assert all(0.0 < v < math.inf for v in res["leaves"].values())
    assert all(math.isfinite(v) for v in res["path_leaves"].values())
