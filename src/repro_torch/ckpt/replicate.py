"""Third-party checkpoint replication (paper §2.1 + §6.5).

A copy of ``repro/ckpt/replicate.py``: the port imports nothing of ``repro``.

After a checkpoint lands on the cluster connector, the managed transfer
service replicates it to a second storage system (e.g. an emulated
cloud object store) WITHOUT the training job in the data path — the
paper's third-party transfer, applied to checkpoint durability.

Concurrency/placement come from the fitted performance model (§5): the
Advisor predicts transfer time per route and picks the best, instead of
exhaustively benchmarking.
"""

from __future__ import annotations

from ..core.perfmodel import Advisor
from ..core.transfer import (Endpoint, TransferOptions, TransferService,
                             TransferTask)


def replicate_checkpoint(service: TransferService, src: Endpoint,
                         dst: Endpoint, step: int,
                         advisor: Advisor | None = None,
                         n_objects_hint: int = 64,
                         bytes_hint: int = 1 << 30,
                         integrity: bool = True,
                         sync: bool = False) -> TransferTask:
    options = TransferOptions(integrity=integrity,
                              checksum_algorithm="lanesum32")
    if advisor is not None and advisor.routes:
        _, cc, predicted = advisor.best(n_objects_hint, bytes_hint)
        options.concurrency = cc
    src_ep = Endpoint(src.connector, f"{src.path}/step_{step}",
                      src.endpoint_id)
    dst_ep = Endpoint(dst.connector, f"{dst.path}/step_{step}",
                      dst.endpoint_id)
    return service.submit(src_ep, dst_ep, options, sync=sync)
