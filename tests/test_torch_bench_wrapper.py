"""The port's bench wrapper (``pretraining_llm_tpu_torch/bench.py``) under
the JAX package's wrapper cases (``tests/test_bench_wrapper.py``), with the
same fake clock and scripted attempts and canaries: hangs are classified
by a canary, a wedged device is polled then reported as an environment
error, a candidate that hangs twice is dropped, the gpt2-124m race reports
its best rung with every rung's numbers and a same-session median, an
explicit --batch or --ce drops rungs, an out-of-memory failure costs one
attempt, a busy device is retried after a backoff, and a structured inner
error is relayed.

Then, over both modules at once so the two stay equal: every mode's flag
guard (the same ``ValueError`` text) and ``error_result``'s metric names.
The JAX program's knobs that change nothing in the port are rejected in
every mode, and the serving modes' record names its paged-attention route.
"""

import json
import re
import sys
from pathlib import Path

import pytest

import bench as jbench
from pretraining_llm_tpu_torch import bench as tbench

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


class _FakeTime:
    """Deterministic clock: sleep() advances it, monotonic() reads it."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s

    def perf_counter(self):  # pragma: no cover - not used by the wrapper
        return self.t


def _wrapper_args(**over):
    # race_repeats=1 keeps the candidate-racing tests single-sample; the
    # median-of-N repeat pass has its own dedicated tests below.
    opts = {"preset": "gpt2-124m", "timeout_budget": "600",
            "race_repeats": "1"}
    opts.update({k: str(v) for k, v in over.items()})
    argv = ["--skip-canary"]
    for k, v in opts.items():
        argv += [f"--{k.replace('_', '-')}", v]
    return tbench.parse_args(argv)


def _run(monkeypatch, capsys, attempts_script, canary_script, args=None):
    """Run wrapper_main with scripted attempt/canary outcomes.

    attempts_script: list of (rec|None, err) popped per _attempt call; a hang
    advances the fake clock by the attempt timeout (like a real kill would).
    canary_script: list of (ok, detail) popped per _run_canary call; the
    last entry repeats forever.
    """
    ft = _FakeTime()
    monkeypatch.setattr(tbench, "time", ft)
    calls = {"attempts": [], "canaries": 0}

    def fake_attempt(a, remat, timeout, attention="", batch_override=0,
                     ce_override=""):
        rec, err = attempts_script.pop(0)
        calls["attempts"].append((remat, attention))
        calls.setdefault("batches", []).append(batch_override)
        calls.setdefault("ces", []).append(ce_override)
        ft.sleep(timeout if "hung" in err else 5.0)
        return rec, err

    def fake_canary(timeout, device="cuda"):
        calls.setdefault("canary_devices", []).append(device)
        i = min(calls["canaries"], len(canary_script) - 1)
        calls["canaries"] += 1
        ft.sleep(5.0 if canary_script[i][0] else timeout)
        return canary_script[i]

    monkeypatch.setattr(tbench, "_attempt", fake_attempt)
    monkeypatch.setattr(tbench, "_run_canary", fake_canary)
    rc = tbench.wrapper_main(args or _wrapper_args())
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out), calls


def _ok(value, remat):
    return ({"metric": "mfu_gpt2-124m_train", "value": value,
             "unit": "fraction_of_peak_bf16", "vs_baseline": value / 0.5,
             "remat": remat}, "")


HUNG = (None, "hung past 150s (killed)")


def test_hang_with_live_canary_moves_to_next_candidate(monkeypatch, capsys):
    # Candidate 1 hangs; canary says the backend is fine => the program was
    # the problem; candidate 2 succeeds and is reported.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[HUNG, _ok(0.41, "save_attn"), _ok(0.39, "save_attn"),
                        _ok(0.38, "none"), _ok(0.37, "none")],
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 0
    assert rec["value"] == 0.41
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn", "none", "none"]
    # Rungs reach the inner run at THEIR batch and CE head (the
    # save_attn_res+dense rung leads, then the save_attn pair, then none).
    assert calls["batches"] == [0, 0, 0, 8, 8]
    assert calls["ces"] == ["dense", "dense", "", "dense", ""]
    assert calls["canaries"] == 1  # exactly one cheap probe after the hang


def test_wedged_backend_is_an_environment_error(monkeypatch, capsys):
    # Hang, then the canary never answers again: the wrapper must poll
    # canaries (not burn full attempts) and report an environment error.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[HUNG],
        canary_script=[(False, "canary hung past 150s (backend unreachable)")],
    )
    assert rc == 1
    assert rec["value"] == 0.0
    assert rec.get("environment_error") is True
    assert "wedged" in rec["error"]
    # Only the first attempt burned a full timeout; everything after was
    # cheap canary polls.
    assert len(calls["attempts"]) == 1
    assert calls["canaries"] >= 2


def test_wedged_then_recovered_retries_same_candidate(monkeypatch, capsys):
    # Hang -> canary dead -> canary recovers -> the SAME candidate gets one
    # retry and succeeds. (Budget must outlive the burnt share: a hang costs
    # min(attempt_timeout, share), so share > 2*attempt_timeout + polls.)
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[HUNG, _ok(0.40, "save_attn_res"),
                        _ok(0.38, "save_attn"), _ok(0.37, "save_attn"),
                        _ok(0.36, "none"), _ok(0.35, "none")],
        canary_script=[(False, "dead"), (True, {"ok": True})],
        args=_wrapper_args(timeout_budget=4200, attempt_timeout=150),
    )
    assert rc == 0
    assert rec["value"] == 0.40  # best of the race, from the retried candidate
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn_res", "save_attn", "save_attn",
        "none", "none"]


def test_double_hang_abandons_candidate(monkeypatch, capsys):
    # A candidate that hangs twice (backend recovering in between) is the
    # problem itself; the wrapper must move on, not wedge the chip a third
    # time.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[HUNG, HUNG, _ok(0.39, "save_attn"),
                        _ok(0.38, "save_attn"), _ok(0.37, "none"),
                        _ok(0.36, "none")],
        canary_script=[(False, "dead"), (True, {"ok": True})],
        args=_wrapper_args(timeout_budget=4200, attempt_timeout=150),
    )
    assert rc == 0
    assert rec["value"] == 0.39
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn_res", "save_attn", "save_attn",
        "none", "none"]


def test_wedge_with_banked_result_reports_it_immediately(monkeypatch, capsys):
    # Candidate 1 already banked a number; candidate 2 hangs and wedges the
    # backend. The wrapper must report the banked result NOW, not poll the
    # dead backend for the rest of the budget.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.30, "save_big"), HUNG],
        canary_script=[(False, "dead")],
    )
    assert rc == 0
    assert rec["value"] == 0.30
    assert len(calls["attempts"]) == 2
    assert calls["canaries"] == 1  # one classifying probe, zero polling


def test_race_reports_best_of_successes(monkeypatch, capsys):
    # Both new policies succeed: the better number wins and the known-good
    # tail is never run (budget preserved).
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.41, "save_attn_res"), _ok(0.40, "save_attn"),
                        _ok(0.39, "save_attn"), _ok(0.30, "none"),
                        _ok(0.28, "none")],
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 0
    assert rec["value"] == 0.41
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn", "none", "none"]
    assert calls["batches"] == [0, 0, 0, 8, 8]
    # Every successful rung's measurement is banked on the winner:
    # losing contenders' values must not vanish from the campaign log.
    assert [r["value"] for r in rec["rungs"]] == [
        0.41, 0.40, 0.39, 0.30, 0.28]


def test_race_repeats_bank_same_session_median(monkeypatch, capsys):
    # The race winner is re-run until --race-repeats same-config
    # samples exist; the record banks {best, median, n, spread} and a
    # value_median, while `value` keeps the best-sample series semantics.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.41, "save_attn_res"), _ok(0.40, "save_attn"),
                        _ok(0.39, "save_attn"), _ok(0.30, "none"),
                        _ok(0.28, "none"), _ok(0.37, "save_attn_res"),
                        _ok(0.44, "save_attn_res")],
        canary_script=[(True, {"ok": True})],
        args=_wrapper_args(race_repeats=3),
    )
    assert rc == 0
    # Repeats re-run the WINNER's exact config (save_attn_res + dense).
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn", "none", "none",
        "save_attn_res", "save_attn_res"]
    assert calls["ces"][-2:] == ["dense", "dense"]
    assert rec["race"] == {"best": 0.44, "median": 0.41, "n": 3,
                           "spread": 0.07, "values": [0.41, 0.37, 0.44]}
    assert rec["value_median"] == 0.41
    # A repeat that beats the original becomes the headline value...
    assert rec["value"] == 0.44
    # ...and every sample (5 race rungs + 2 repeats) stays in the evidence.
    assert len(rec["rungs"]) == 7


def test_race_repeat_failure_keeps_partial_samples(monkeypatch, capsys):
    # A deterministic failure during repeats must stop the sampling loop
    # cold (no retry ladder): the median is over the samples that exist.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.41, "save_attn_res"), _ok(0.40, "save_attn"),
                        _ok(0.39, "save_attn"), _ok(0.30, "none"),
                        _ok(0.28, "none"), _ok(0.39, "save_attn_res"),
                        (None, "rc=1: RuntimeError: boom")],
        canary_script=[(True, {"ok": True})],
        args=_wrapper_args(race_repeats=4),
    )
    assert rc == 0
    assert rec["value"] == 0.41
    assert rec["race"]["n"] == 2
    assert rec["race"]["values"] == [0.41, 0.39]
    assert rec["race"]["median"] == 0.4
    assert calls["canaries"] == 0  # not a hang: no probe burned


def test_hung_race_repeat_marks_wedge_and_reports(monkeypatch, capsys):
    # A repeat that hangs and kills the backend must still report the
    # collected samples NOW, marked backend_wedged for chained callers.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.41, "save_attn_res"), _ok(0.40, "save_attn"),
                        _ok(0.39, "save_attn"), _ok(0.30, "none"),
                        _ok(0.28, "none"), HUNG],
        canary_script=[(False, "dead")],
        args=_wrapper_args(race_repeats=3),
    )
    assert rc == 0
    assert rec["value"] == 0.41
    assert rec.get("backend_wedged") is True
    assert rec["race"]["n"] == 1
    assert calls["canaries"] == 1  # one classifying probe, zero polling


def test_explicit_batch_drops_override_rungs(monkeypatch, capsys):
    # `--batch 24` is a series point the caller chose; the race must not
    # silently answer it with a batch-8 measurement. With
    # the none@8 rung dropped there is no second CONTENDER, so a first-rung
    # success ends the race — the measured-slower save_big fallback must
    # not burn hardware window that cannot improve the number.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.40, "save_attn_res"), _ok(0.39, "save_attn"),
                        _ok(0.38, "save_attn")],
        canary_script=[(True, {"ok": True})],
        args=_wrapper_args(batch=24),
    )
    assert rc == 0
    assert rec["value"] == 0.40
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn"]
    assert calls["batches"] == [0, 0, 0]  # no per-candidate override in play
    assert calls["ces"] == ["dense", "dense", ""]  # ce rungs race at --batch


def test_matching_explicit_batch_keeps_override_rung(monkeypatch, capsys):
    # `--batch 8` equals the none rung's own batch: the rung stays, so a
    # banked none@8 race win is reproducible at its explicit batch.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.40, "save_attn_res"), _ok(0.39, "save_attn"),
                        _ok(0.38, "save_attn"), _ok(0.52, "none"),
                        _ok(0.50, "none")],
        canary_script=[(True, {"ok": True})],
        args=_wrapper_args(batch=8),
    )
    assert rc == 0
    assert rec["value"] == 0.52
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn", "none", "none"]


def test_explicit_ce_drops_override_rungs(monkeypatch, capsys):
    # `--ce chunked` applies to every rung; the dense-overridden rung would
    # be a duplicate of its plain sibling (or a contradiction of the
    # caller's choice) and must not burn a contender share.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[_ok(0.40, "save_attn"), _ok(0.38, "none")],
        canary_script=[(True, {"ok": True})],
        args=_wrapper_args(ce="chunked"),
    )
    assert rc == 0
    assert rec["value"] == 0.40
    assert [r for r, _ in calls["attempts"]] == ["save_attn", "none"]
    assert calls["ces"] == ["", ""]  # no per-candidate CE override in play


def test_oom_is_deterministic_not_transient(monkeypatch, capsys):
    # Retrying the identical run only drains the rung's budget share: one
    # bounded attempt, then the next candidate.
    oom = (None, "rc=1: torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 18.30 GiB. "
                 "GPU 0 has a total capacity of 79.19 GiB of which 1.02 GiB is free.")
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[oom, _ok(0.41, "save_attn"), _ok(0.40, "save_attn"),
                        _ok(0.39, "none"), _ok(0.38, "none")],
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 0
    assert rec["value"] == 0.41
    # Exactly ONE attempt on the OOM-ing candidate, no backoff retries.
    assert [r for r, _ in calls["attempts"]] == [
        "save_attn_res", "save_attn", "save_attn", "none", "none"]


def test_environment_error_cites_no_banked_number(monkeypatch, capsys):
    # A dead device's record is the bare error: the port keeps no capture
    # of its own runs, and a TPU number is never given as the port's.
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[HUNG],
        canary_script=[(False, "canary hung past 150s (backend unreachable)")],
    )
    assert rc == 1
    assert rec.get("environment_error") is True
    assert "last_banked" not in rec and rec["value"] == 0.0


def test_busy_device_is_retried_after_a_backoff(monkeypatch, capsys):
    busy = (None, "rc=1: RuntimeError: CUDA error: all CUDA-capable devices are busy or unavailable")
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[busy, _ok(0.41, "save_attn_res"), _ok(0.40, "save_attn"), _ok(0.39, "save_attn"),
                        _ok(0.38, "none"), _ok(0.37, "none")],
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 0 and rec["value"] == 0.41
    assert [r for r, _ in calls["attempts"]][:2] == ["save_attn_res", "save_attn_res"]


def test_deterministic_failure_moves_to_the_next_rung(monkeypatch, capsys):
    boom = (None, "rc=1: RuntimeError: CUDA error: an illegal memory access was encountered")
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[boom, _ok(0.40, "save_attn"), _ok(0.39, "save_attn"), _ok(0.38, "none"),
                        _ok(0.37, "none")],
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 0 and rec["value"] == 0.40
    assert [r for r, _ in calls["attempts"]] == ["save_attn_res", "save_attn", "save_attn", "none", "none"]


def test_canary_probes_the_requested_device(monkeypatch, capsys):
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[],
        canary_script=[(False, "canary failed rc=1: no CUDA device is available")],
        args=tbench.parse_args(["--device", "cpu", "--mode", "kernel"]),
    )
    assert rc == 1 and rec["environment_error"] is True
    assert rec["metric"] == "kernel_ragged_microbench_ms" and rec["vs_baseline"] is None
    assert calls["canary_devices"] == ["cpu", "cpu"]  # one retry
    assert calls["attempts"] == []


GUARDS = [
    # (runner name, argv, rejected-flag fragment)
    ("run_serving_bench", ["--mode", "serving", "--remat", "save_attn"], "--remat"),
    ("run_serving_bench", ["--mode", "serving", "--decode-unroll"], "--decode-unroll"),
    ("run_serving_bench", ["--mode", "serving", "--prefix-pool-size", "4"], "--prefix-pool-size"),
    ("run_decode_bench", ["--mode", "decode", "--steps-per-sched", "4"], "--steps-per-sched"),
    ("run_decode_bench", ["--mode", "decode", "--optimizer", "adafactor"], "--optimizer"),
    ("run_decode_bench", ["--mode", "decode", "--context", "2048"], "--context"),
    ("run_decode_bench", ["--mode", "decode", "--quantize", "int8"], "--quantize"),
    ("run_trainer_bench", ["--mode", "trainer", "--cache-layout", "stacked"], "--cache-layout"),
    ("run_trainer_bench", ["--mode", "trainer", "--context", "2048"], "--context"),
    ("run_kernel_bench", ["--mode", "kernel", "--batch", "4", "--kv-dtype", "int8"], "--batch, --kv-dtype"),
    ("run_serving_slo_bench", ["--mode", "serving-slo", "--spec-draft", "self"], "--spec-draft"),
    ("run_serving_fleet_bench", ["--mode", "serving-fleet", "--quantize", "int8"], "--quantize"),
    ("run_serving_fleet_bench", ["--mode", "serving-fleet", "--replicas", "1"], "--replicas >= 2"),
    ("run_bench", ["--ragged", "--prefix-cache"], "--ragged, --prefix-cache"),
]


@pytest.mark.parametrize("module", [jbench, tbench], ids=["jax", "port"])
def test_mode_flag_guards_reject_foreign_knobs(module):
    """Every mode rejects the other modes' knobs, with the same text in
    both packages: a silently ignored flag would file a record under the
    default run's series."""
    for runner, argv, frag in GUARDS:
        with pytest.raises(ValueError, match=re.escape(frag)) as exc:
            getattr(module, runner)(module.parse_args(argv))
        other = tbench if module is jbench else jbench
        with pytest.raises(ValueError) as twin:
            getattr(other, runner)(other.parse_args(argv))
        assert str(exc.value) == str(twin.value), runner


METRICS = [
    (["--mode", "decode"], "decode_tokens_per_sec_gpt2-124m_unstacked"),
    (["--mode", "decode", "--cache-layout", "stacked"], "decode_tokens_per_sec_gpt2-124m"),
    (["--mode", "decode", "--ragged", "--kv-dtype", "int8"], "decode_tokens_per_sec_gpt2-124m_ragged_kvint8_unstacked"),
    (["--mode", "serving"], "serving_tokens_per_sec_gpt2-124m_unstacked"),
    (["--mode", "serving-slo", "--preset", "tiny"], "serving_slo_goodput_tiny"),
    (["--mode", "trainer"], "trainer_tokens_per_sec_gpt2-124m"),
    (["--mode", "kernel"], "kernel_ragged_microbench_ms"),
    (["--context", "16384", "--preset", "gpt2-8k-sp"], "mfu_gpt2-8k-sp_train_ctx16384"),
    ([], "mfu_gpt2-124m_train"),
]


@pytest.mark.parametrize("module", [jbench, tbench], ids=["jax", "port"])
def test_error_result_metric_mirrors_success_series(module):
    """A failed run files under the success series of the same invocation,
    the same name in both packages, with the same unit and baseline."""
    for argv, metric in METRICS:
        rec = module.error_result(module.parse_args(argv), "boom", 1)
        twin = (tbench if module is jbench else jbench).error_result(jbench.parse_args(argv), "boom", 1)
        assert rec["metric"] == metric
        # The port's serving records also name their paged-attention route.
        jrec, trec = (rec, twin) if module is jbench else (twin, rec)
        assert {k: trec[k] for k in jrec} == jrec
        assert set(trec) - set(jrec) <= {"paged_attention_impl"}


RUNNERS = {
    "train": "run_bench", "decode": "run_decode_bench", "trainer": "run_trainer_bench",
    "serving": "run_serving_bench", "serving-slo": "run_serving_slo_bench",
    "serving-fleet": "run_serving_fleet_bench", "kernel": "run_kernel_bench",
}


# The modes in which the JAX program uses each knob; its other modes reject it.
JAX_USES = {"--unroll": {"train", "trainer"}, "--decode-unroll": {"decode"},
            "--cache-layout": {"decode", "serving", "serving-slo", "serving-fleet"}}


@pytest.mark.parametrize("flag", [["--unroll", "4"], ["--cache-layout", "stacked"], ["--decode-unroll"]],
                         ids=["unroll", "cache-layout", "decode-unroll"])
def test_knobs_without_effect_on_the_port_are_rejected_in_every_mode(flag):
    """The JAX program's scan unroll, cache layout and unrolled decode
    change nothing in the port: every mode rejects them, with the JAX
    package's text where its mode rejects them too and the port's text
    where the JAX program would use them, so no record of the default
    program files under another series."""
    for mode, runner in RUNNERS.items():
        argv = ["--mode", mode, *flag]
        with pytest.raises(ValueError) as got:
            getattr(tbench, runner)(tbench.parse_args(argv))
        if mode in JAX_USES[flag[0]]:
            assert str(got.value) == f"{flag[0]} have no effect on the port", mode
        else:
            with pytest.raises(ValueError) as want:
                getattr(jbench, runner)(jbench.parse_args(argv))
            assert str(got.value) == str(want.value), mode


@pytest.mark.parametrize("mode", ["serving", "serving-slo", "serving-fleet"])
def test_serving_error_names_its_paged_route(mode):
    """The serving modes run the kernels by default; the plain gather is
    another program and files under its own series."""
    from pretraining_llm_tpu_torch.config import get_preset

    args = tbench.parse_args(["--mode", mode])
    default = tbench.error_result(args, "boom", 1)
    gather = tbench.error_result(tbench.parse_args(["--mode", mode, "--paged-attn", "gather"]), "boom", 1)
    assert default["paged_attention_impl"] == "kernel" and gather["paged_attention_impl"] == "gather"
    assert gather["metric"] == default["metric"] + "_gather"
    assert tbench._serving_model(args, get_preset("tiny").model).paged_attention_impl == "kernel"


def test_serving_fleet_error_names_its_series():
    # The JAX package's error_result has no serving-fleet branch (its
    # failures fall through to the train series); the port names the
    # scenario's series, as the success path does.
    args = tbench.parse_args(["--mode", "serving-fleet", "--fleet-scenario", "partition"])
    rec = tbench.error_result(args, "boom", 1)
    assert rec["metric"] == "serving_fleet_partition_gpt2-124m"
    assert rec["unit"] == "slo_ok_requests_per_sec" and rec["vs_baseline"] is None


def test_structured_inner_error_is_relayed(monkeypatch, capsys):
    # Deterministic inner failures relay the inner run's structured record.
    inner = {"metric": "mfu_gpt2-124m_train", "value": 0.0,
             "unit": "fraction_of_peak_bf16", "vs_baseline": 0.0,
             "error": "RuntimeError: boom", "attempts": 1}
    rc, rec, calls = _run(
        monkeypatch, capsys,
        attempts_script=[(inner, "rc=1: RuntimeError")] * 8,
        canary_script=[(True, {"ok": True})],
    )
    assert rc == 1
    assert rec["error"] == "RuntimeError: boom"


def test_attempt_forwards_the_device_and_the_mode_flags(monkeypatch):
    seen = {}

    class Done:
        returncode, stdout = 0, '{"metric": "m", "value": 1.0}\n'

    def fake_run(cmd, **kw):
        seen["cmd"], seen["cwd"] = cmd, kw.get("cwd")
        return Done()

    monkeypatch.setattr(tbench.subprocess, "run", fake_run)
    args = tbench.parse_args(["--device", "cpu", "--mode", "serving-fleet", "--fleet-scenario", "hotprefix",
                              "--prefix-len", "16", "--slo-ttft-s", "2"])
    rec, err = tbench._attempt(args, "", 10.0)
    cmd = seen["cmd"]
    assert (rec, err) == ({"metric": "m", "value": 1.0}, "")
    assert cmd[:4] == [sys.executable, "-m", "pretraining_llm_tpu_torch.bench", "--_inner"]
    assert Path(seen["cwd"]) == ROOT
    for flag, value in (("--device", "cpu"), ("--mode", "serving-fleet"), ("--fleet-scenario", "hotprefix"),
                        ("--prefix-len", "16"), ("--slo-ttft-s", "2.0")):
        assert cmd[cmd.index(flag) + 1] == value
