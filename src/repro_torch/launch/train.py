"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

End-to-end run of the port's stack, after ``repro/launch/train.py``:
a synthetic token corpus written and read through the POSIX Connector,
the train step, async checkpoints with lanesum32 digests, restart from
the latest checkpoint and, with ``--replicate-to <provider>``, each
checkpoint replicated to an emulated cloud object store by a third-party
``TransferService`` task that re-verifies the lanesum32 digests at the
destination (paper §2.1, §7).  Every family the port builds trains: the
dense and MoE families (the MoE load-balance loss joins the objective, as
in the reference), jamba and rwkv6; jamba's ``--n-layers`` must divide by
its 8-layer block.  It trains a scaled-down model on the card;
``--no-scaled-down`` (or ``--full-size``) trains the full-width config,
``--n-layers`` cuts its depth, ``--device cpu`` runs on the CPU.  Weights
are random, drawn from a ``torch.Generator`` seeded with ``--seed``; the
corpus is drawn from numpy with the same seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from ..ckpt import CheckpointManager, replicate_checkpoint
from ..configs import get_config
from ..connectors import ObjectStoreConnector, PosixConnector, make_cloud
from ..core import Credential
from ..core.transfer import CredentialStore, Endpoint, TransferService
from ..data import DataPipelineConfig, ShardedTokenDataset, synthetic_corpus
from ..models.registry import build
from ..optim import OptimizerConfig
from ..runtime.train import TrainLoopConfig, run_training


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--scaled-down", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--full-size", dest="scaled_down", action="store_false")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--retain", type=int, default=3,
                    help="checkpoints kept on storage")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro-torch-train"))
    ap.add_argument("--replicate-to", default=None,
                    help="cloud provider id (s3|gcs|...) for third-party "
                         "checkpoint replication")
    ap.add_argument("--data-records", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="raise before this step, as a preemption would")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


class Replicator:
    """Replicates ``src``'s checkpoint of a step to ``mirror`` through a
    third-party task of ``service`` (integrity on, lanesum32), as the
    reference launcher's replicator does.  Keeps (step, task, host wall
    seconds) of each replication in ``done``."""

    def __init__(self, service: TransferService, src: Endpoint, mirror: Endpoint):
        self.service, self.src, self.mirror = service, src, mirror
        self.done: list = []

    def __call__(self, step: int) -> None:
        t0 = time.perf_counter()  # lint: disable=R001(reports the replication's real wall seconds — outside the transfer model entirely)
        task = replicate_checkpoint(self.service, self.src, self.mirror, step, sync=True)
        self.done.append((step, task, time.perf_counter() - t0))  # lint: disable=R001(reports the replication's real wall seconds)
        print(f"  replicated step {step}: {task.status} "
              f"({task.stats.bytes_done / 1e6:.1f} MB)")


@dataclasses.dataclass
class TrainSetup:
    api: object
    opt: OptimizerConfig
    loop: TrainLoopConfig
    data: ShardedTokenDataset
    ckpt: CheckpointManager
    replicator: Replicator | None = None


def setup(args: argparse.Namespace) -> TrainSetup:
    """Builds the model, writes the corpus under ``--ckpt-dir`` and opens
    the dataset and the checkpoint manager on it; with ``--replicate-to``,
    also the emulated object store and the transfer service that mirror
    each checkpoint."""
    cfg = get_config(args.arch)
    if args.scaled_down:
        cfg = cfg.scaled_down()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    api = build(cfg, args.device)

    store = PosixConnector(os.path.abspath(args.ckpt_dir))
    # data through the Connector interface
    synthetic_corpus(store, "corpus", vocab_size=cfg.vocab_size,
                     seq_len=args.seq_len, n_records=args.data_records,
                     seed=args.seed, records_per_shard=64)
    ds = ShardedTokenDataset(store, "corpus", DataPipelineConfig(
        seq_len=args.seq_len, batch_size=args.batch_size))
    ckpt_mgr = CheckpointManager(store, "ckpt", retain=args.retain)
    replicator = None
    if args.replicate_to:
        conn = ObjectStoreConnector(make_cloud(args.replicate_to), placement="cloud")
        creds = CredentialStore()
        creds.register("mirror", Credential(conn.credential_scheme, {}))
        replicator = Replicator(TransferService(credential_store=creds),
                                Endpoint(store, "ckpt"), Endpoint(conn, "mirror", "mirror"))
    opt = OptimizerConfig(peak_lr=args.lr, warmup_steps=20,
                          total_steps=args.steps, state_dtype="float32")
    loop = TrainLoopConfig(total_steps=args.steps, log_every=args.log_every,
                           ckpt_every=args.ckpt_every,
                           replicate_every=args.ckpt_every if replicator else 0,
                           seed=args.seed, fail_at_step=args.fail_at_step)
    return TrainSetup(api, opt, loop, ds, ckpt_mgr, replicator)


def main(argv=None):
    args = parse_args(argv)
    s = setup(args)
    result = run_training(s.api, s.opt, s.loop, s.data, ckpt_mgr=s.ckpt,
                          replicator=s.replicator)
    print(f"done: {result.steps_run} steps on {s.api.device}, final loss "
          f"{result.final_loss:.4f}, {result.tokens_per_second:.0f} tok/s"
          + (f", restored from step {result.restored_from}"
             if result.restored_from else ""))
    return result


if __name__ == "__main__":
    main()
