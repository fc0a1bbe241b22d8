"""Fault-tolerant training loop, ported from ``repro/runtime/train.py``.

Wires together the Connector-backed data pipeline, the train step and
async Connector checkpointing and third-party checkpoint replication
(``replicator``, called after a save every ``replicate_every`` steps).
Restart is crash-consistent: (model state, data-iterator cursor) restore
from the latest committed checkpoint.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch

from ..ckpt import CheckpointManager
from ..ckpt.io import get_bytes, put_bytes
from ..core.errors import NotFound
from ..models.registry import ModelApi
from ..optim import OptimizerConfig
from .steps import make_train_state, make_train_step


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    replicate_every: int = 0      # 0 = off
    seed: int = 0
    fail_at_step: int = -1        # fault injection for tests


@dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: list = field(default_factory=list)       # (step, loss) per log step
    restored_from: int | None = None
    tokens_per_second: float = 0.0
    grad_norms: list = field(default_factory=list)   # (step, grad norm) per log step
    #: host wall seconds of each step run, from its batch on the device to
    #: its loss on the host (checkpoints not included)
    step_seconds: list = field(default_factory=list)


class InjectedFailure(RuntimeError):
    """The failure ``fail_at_step`` injects.  ``result`` holds what the
    steps before it did."""

    def __init__(self, step: int, result: TrainResult):
        super().__init__(f"injected failure at step {step}")
        self.result = result


def run_training(api: ModelApi, opt_cfg: OptimizerConfig,
                 loop_cfg: TrainLoopConfig, data_iter,
                 ckpt_mgr: CheckpointManager | None = None,
                 replicator=None, state=None) -> TrainResult:
    """Trains to ``loop_cfg.total_steps``.  ``state`` is the initial train
    state (default: ``make_train_state`` seeded with ``loop_cfg.seed``); it
    is updated in place, and replaced by the latest checkpoint if
    ``ckpt_mgr`` has one.  ``replicator(step)`` runs after a save of a step
    that ``loop_cfg.replicate_every`` divides, once its ``data_state.json``
    is written."""
    step_fn = make_train_step(api, opt_cfg)
    if state is None:
        state = make_train_state(
            api, opt_cfg, torch.Generator(api.device).manual_seed(loop_cfg.seed))
    start_step = 0
    restored_from = None
    if ckpt_mgr is not None:
        restored, step = ckpt_mgr.restore_latest(state)
        if restored is not None:
            state = restored
            start_step = step
            restored_from = step
            # resume the data cursor
            try:
                session = ckpt_mgr.connector.start(ckpt_mgr.credential)
                cursor = json.loads(get_bytes(
                    ckpt_mgr.connector, session,
                    f"{ckpt_mgr.base}/step_{step}/data_state.json"))
                ckpt_mgr.connector.destroy(session)
                if hasattr(data_iter, "restore"):
                    data_iter.restore(cursor)
            except NotFound:
                pass

    batches = (data_iter.prefetching_batches()
               if hasattr(data_iter, "prefetching_batches") else data_iter)
    losses, grad_norms, step_seconds = [], [], []
    t0 = time.perf_counter()  # lint: disable=R001(tokens/s is a real training-throughput stat — outside the transfer model entirely)
    tokens = 0
    step = start_step

    def result(steps_run):
        dt = max(time.perf_counter() - t0, 1e-9)  # lint: disable=R001(tokens/s is a real training-throughput stat)
        return TrainResult(steps_run=steps_run,
                           final_loss=losses[-1][1] if losses else float("nan"),
                           losses=losses, restored_from=restored_from,
                           tokens_per_second=tokens / dt, grad_norms=grad_norms,
                           step_seconds=step_seconds)

    for step in range(start_step + 1, loop_cfg.total_steps + 1):
        batch = next(batches) if hasattr(batches, "__next__") \
            else next(iter(batches))
        batch = {k: torch.tensor(v, device=api.device) for k, v in batch.items()}
        if loop_cfg.fail_at_step == step:
            raise InjectedFailure(step, result(step - 1 - start_step))
        ts = time.perf_counter()  # lint: disable=R001(step_seconds is a real training step's wall time)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        step_seconds.append(time.perf_counter() - ts)  # lint: disable=R001(step_seconds is a real training step's wall time)
        tokens += batch["tokens"].numel()
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps:
            gnorm = float(metrics["grad_norm"])
            losses.append((step, loss))
            grad_norms.append((step, gnorm))
            print(f"step {step}: loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {gnorm:.2f}")
        if ckpt_mgr is not None and (step % loop_cfg.ckpt_every == 0
                                     or step == loop_cfg.total_steps):
            ckpt_mgr.save_async(state, step)
            ckpt_mgr.wait()
            if hasattr(data_iter, "state"):
                session = ckpt_mgr.connector.start(ckpt_mgr.credential)
                put_bytes(ckpt_mgr.connector, session,
                          f"{ckpt_mgr.base}/step_{step}/data_state.json",
                          json.dumps(data_iter.state()).encode())
                ckpt_mgr.connector.destroy(session)
            if replicator is not None and loop_cfg.replicate_every and \
                    step % loop_cfg.replicate_every == 0:
                replicator(step)
    return result(step - start_step)
