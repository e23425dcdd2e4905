"""The trajectory study (``pretraining_llm_tpu_torch/utils/trajectory.py``)
on the CPU at the tiny preset's size, fp32, with document masking on
``data/parity`` bytes. There the head x attention settings differ only in
summation order: same-state losses within 1e-5 and every gradient leaf
within 1e-5 relative of the twin's; the runs apart by less than 1e-4 over
three steps, the ulp-moved ones included.
"""

import math

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
