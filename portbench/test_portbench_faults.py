"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound program reads ``correct``, and the same run with
the timed path broken underneath, or the reference in fp8 in the
program's place (the control) and judged by the same check, does not."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, tiny

TRAIN = "granite-moe-1b-a400m.train_4k"
PREFILLS = ["h2o-danube-3-4b.prefill_long", "h2o-danube-3-4b.prefill_short"]
SEED = 2**31 + 11


def run(workload, seconds=0.3, **traffic):
    return harness.run(tiny.cell(workload, **traffic), SEED, seconds, False, device="cpu")


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_a_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert list(out)[-1] == "check"


def unchanged_state(monkeypatch):
    from repro_torch.runtime import steps

    monkeypatch.setattr(steps, "adamw_update",
                        lambda params, grads, opt, cfg: (params, opt, {}))


def half_the_batch(monkeypatch):
    from repro_torch.runtime import steps

    whole = steps.value_and_grad
    monkeypatch.setattr(steps, "value_and_grad", lambda api, params, batch: whole(
        api, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


def labels_off_by_one(monkeypatch):
    from repro_torch.models import transformer

    xent = transformer.chunked_xent
    monkeypatch.setattr(transformer, "chunked_xent", lambda table, x, labels, chunk: xent(
        table, x, labels.roll(1, dims=1), chunk=chunk))


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch, labels_off_by_one])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not run(TRAIN)["correct"]


def token_altered(monkeypatch):
    from repro_torch.models import transformer

    logits_last = transformer.logits_last
    monkeypatch.setattr(transformer, "logits_last", lambda params, x, cfg: logits_last(
        params, x, cfg).roll(1, dims=-1))


def half_the_requests(monkeypatch):
    from repro_torch.models import transformer

    prefill = transformer.prefill

    def half(params, batch, cfg, pad_to=None):
        B = batch["tokens"].shape[0]
        logits, cache, pos = prefill(params, {"tokens": batch["tokens"][: B // 2]}, cfg, pad_to)
        return torch.cat([logits, logits]), cache, pos

    monkeypatch.setattr(transformer, "prefill", half)


# a batch of one request has no half to leave out
@pytest.mark.parametrize("workload,fault", [(w, f) for w in PREFILLS for f in (
    token_altered, half_the_requests) if f is token_altered or tiny.cell(w).traffic["batch"] > 1])
def test_a_broken_prefill_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    assert not run(workload)["correct"]


def ticking_clock():
    """A ``time`` whose clock advances a millisecond a read: a prefill
    window of the same work whatever the machine's load."""
    now = iter(range(10**9))
    return SimpleNamespace(perf_counter=lambda: next(now) * 1e-3)


@pytest.mark.parametrize("workload", [TRAIN] + PREFILLS)
def test_the_control_is_not_correct(monkeypatch, workload):
    """The reference in fp8 put in the program's place, judged by the run's
    own check.  At the tiny size one served token's gap swings widely, so
    the prefills check 256 of their window's, as a cell checks hundreds."""
    kind = tiny.cell(workload).traffic["kind"]
    mod = harness.kind_module(kind)
    monkeypatch.setattr(mod.Bench, "stand_in", "fp8")
    more = {}
    if kind == "prefill":
        monkeypatch.setattr(mod, "time", ticking_clock())
        more = {"check_requests": 256}
    out = run(workload, 1.0, **more)
    assert not out["correct"], out["check"]
