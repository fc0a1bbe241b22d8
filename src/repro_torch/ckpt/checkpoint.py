"""Checkpointing through the Connector interface, ported from
``repro/ckpt/checkpoint.py`` over nested dicts and lists of tensors.

The layout is the reference's, so a manifest written here is byte-identical
to the reference's for the same state, and each side restores the other's
checkpoints:

* every leaf becomes one object, named by its ``flatten`` path, except
  leaves under ``bundle_threshold`` bytes, which are coalesced into bundle
  objects flushed at 8x the threshold (paper §5: per-file overhead);
* ``manifest.json`` records, per leaf in sorted path order, the object,
  shape, numpy dtype name and a lanesum32 digest;
* saves are atomic: objects land under ``<step>.tmp/``, the manifest is the
  commit point, then the directory is renamed and ``LATEST`` written.

Unlike the reference, which hashes host bytes, both ends of paper §7 run on
the device that holds the tensors: the source digest of each leaf is taken
from its device copy (``checksum_digests``, the lanesum32 kernel on CUDA),
and post-write and restore verification digest the bytes read back from
storage after they are copied to that device.  One kernel is launched per
leaf: the save reads each leaf's sums back before its host copy, the
verification passes read all the sums back once.

Leaves are written as their row-major bytes (``t.contiguous()`` viewed as
uint8) and read back with ``torch.frombuffer`` and a ``view`` to the
manifest's dtype, so bfloat16 needs no numpy support for it.

The format does not depend on a mesh.  A ``DTensor`` leaf is saved as its
full tensor (every rank gathers it, one leaf at a time; rank 0 digests,
copies and writes it), so a sharded save is byte for byte the unsharded
save of the same state.  ``restore_checkpoint``
with ``shardings`` has every rank read each full leaf, verify its digest
on the mesh's device, and keep its own shard (elastic restart onto another
mesh).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..core.connector import Connector, Credential
from ..core.errors import IntegrityError, NotFound
from ..kernels.checksum.ops import checksum_digests
from ..models.convert import flatten, unflatten
from .io import get_bytes, put_bytes

MB = 1024 * 1024


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as manifests record it."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    return dt


def _digests(devices: list[torch.device], make) -> list[str]:
    """Digests of ``make(i)``, a tensor on ``devices[i]``, for every i: one
    batched pass per device, each tensor made just before its kernel
    launches, so that only one need exist at a time."""
    out: list[str | None] = [None] * len(devices)
    for dev in dict.fromkeys(devices):
        idx = [i for i, d in enumerate(devices) if d == dev]
        for i, dig in zip(idx, checksum_digests(make(i) for i in idx)):
            out[i] = dig
    return out


def _to_device(data: bytes, device: torch.device) -> torch.Tensor:
    """Storage bytes as a uint8 tensor on ``device`` (a copy it owns)."""
    if not data:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


@dataclass
class HostLeaf:
    """One leaf's row-major bytes on the host, with its device digest
    (both ``None`` on the ranks that do not write a sharded save)."""

    path: str
    data: memoryview | None
    checksum: str | None
    shape: list
    dtype: str
    device: torch.device


def snapshot(state, timings: dict | None = None) -> list[HostLeaf]:
    """Digests every leaf of ``state`` on its device, then copies its bytes
    to the host, one leaf at a time, as the reference saves.  Both are done
    when this returns, so the caller may update ``state`` in place
    afterwards.  Leaves come in sorted path order.  A ``DTensor`` leaf is
    gathered just before its digest and dropped after its copy, so a rank
    holds at most one full leaf beside its shards; every rank must call
    this, and only rank 0 of the default group, which writes, digests and
    keeps host bytes."""
    timings = {} if timings is None else timings
    leaves = sorted(flatten(state).items())
    keep = (not any(isinstance(t, DTensor) for _, t in leaves)) or dist.get_rank() == 0
    out, digest_s, d2h_s, nbytes = [], 0.0, 0.0, 0
    for path, t in leaves:
        t = (t.full_tensor() if isinstance(t, DTensor) else t).detach().contiguous()
        data = dig = None
        if keep:
            t0 = time.perf_counter()  # lint: disable=R001(save timings are real host and device seconds — outside the transfer model entirely)
            dig = checksum_digests([t])[0]
            # the digest read back: the device work is done
            t1 = time.perf_counter()  # lint: disable=R001(save timings are real host and device seconds)
            # a blocking copy, made on the CPU too: there ``.cpu()`` would alias the
            # live tensor, and the writer thread would write bytes from after the
            # caller's next in-place update under the digest taken before it
            host = t.reshape(-1).view(torch.uint8).to("cpu", copy=True)
            d2h_s += time.perf_counter() - t1  # lint: disable=R001(save timings are real host and device seconds)
            digest_s += t1 - t0
            nbytes += host.numel()
            data = memoryview(host.numpy())
        out.append(HostLeaf(path, data, dig, list(t.shape), dtype_name(t.dtype), t.device))
    timings.update(leaves=len(leaves), digest_s=digest_s, d2h_s=d2h_s, bytes=nbytes)
    return out


def write_snapshot(leaves: list[HostLeaf], connector: Connector, base: str,
                   step: int, credential: Credential | None = None,
                   bundle_threshold: int = 4 * MB, verify: bool = True,
                   timings: dict | None = None) -> dict:
    """Writes snapshotted leaves under ``base/step_<n>/``.  Returns the
    manifest."""
    timings = {} if timings is None else timings
    t0 = time.perf_counter()  # lint: disable=R001(save timings are real host and device seconds)
    session = connector.start(credential)
    tmp = f"{base}/step_{step}.tmp"
    final = f"{base}/step_{step}"
    manifest = {"step": step, "objects": {}, "bundles": {},
                "checksum_algorithm": "lanesum32"}
    try:
        bundle: list[HostLeaf] = []
        bundle_size = 0
        bundle_idx = 0

        def flush_bundle():
            nonlocal bundle, bundle_size, bundle_idx
            if not bundle:
                return
            name = f"bundle_{bundle_idx}.bin"
            blob = b"".join(leaf.data for leaf in bundle)
            put_bytes(connector, session, f"{tmp}/{name}", blob)
            off = 0
            for leaf in bundle:
                manifest["bundles"][leaf.path] = {
                    "object": name, "offset": off, "length": len(leaf.data),
                    "checksum": leaf.checksum, "shape": leaf.shape,
                    "dtype": leaf.dtype,
                }
                off += len(leaf.data)
            bundle_idx += 1
            bundle = []
            bundle_size = 0

        by_path = {}
        for leaf in sorted(leaves, key=lambda leaf: leaf.path):
            by_path[leaf.path] = leaf
            if len(leaf.data) < bundle_threshold:
                bundle.append(leaf)
                bundle_size += len(leaf.data)
                if bundle_size >= 8 * bundle_threshold:
                    flush_bundle()
                continue
            obj = f"{leaf.path.replace('/', '.')}.bin"
            put_bytes(connector, session, f"{tmp}/{obj}", leaf.data)
            manifest["objects"][leaf.path] = {
                "object": obj, "checksum": leaf.checksum,
                "shape": leaf.shape, "dtype": leaf.dtype,
            }
        flush_bundle()
        t1 = time.perf_counter()  # lint: disable=R001(save timings are real host and device seconds)

        if verify:  # §7: re-read from storage, digest on the leaf's device
            paths = list(manifest["objects"])
            devices = [by_path[p].device for p in paths]
            got = _digests(devices, lambda i: _to_device(get_bytes(
                connector, session, f"{tmp}/{manifest['objects'][paths[i]]['object']}"),
                devices[i]))
            for path, dig in zip(paths, got):
                if dig != manifest["objects"][path]["checksum"]:
                    raise IntegrityError(f"post-write verify failed: {path}")
        t2 = time.perf_counter()  # lint: disable=R001(save timings are real host and device seconds)

        put_bytes(connector, session, f"{tmp}/manifest.json",
                  json.dumps(manifest).encode())
        connector.command(session, "rename", tmp, to=final)
        # update the "latest" pointer last (atomic-ish commit marker)
        put_bytes(connector, session, f"{base}/LATEST", str(step).encode())
        timings.update(objects=len(manifest["objects"]),
                       bundled=len(manifest["bundles"]),
                       verified=len(manifest["objects"]) if verify else 0,
                       write_s=time.perf_counter() - t2 + t1 - t0,  # lint: disable=R001(save timings are real host and device seconds)
                       verify_s=t2 - t1)
        return manifest
    finally:
        connector.destroy(session)


def save_checkpoint(state, connector: Connector, base: str, step: int,
                    credential: Credential | None = None,
                    bundle_threshold: int = 4 * MB,
                    verify: bool = True) -> dict:
    """Writes ``state`` under ``base/step_<n>/``.  Returns the manifest.
    With ``DTensor`` leaves every rank must call it (each takes part in
    gathering each full leaf in turn); rank 0 of the default group digests,
    copies and writes them and sends the others the manifest it wrote."""
    leaves = snapshot(state)
    if not any(isinstance(t, DTensor) for t in flatten(state).values()):
        return write_snapshot(leaves, connector, base, step, credential,
                              bundle_threshold, verify)
    box = [None]
    if dist.get_rank() == 0:
        box[0] = write_snapshot(leaves, connector, base, step, credential,
                                bundle_threshold, verify)
    dist.broadcast_object_list(box, src=0)
    return box[0]


def latest_step(connector: Connector, base: str,
                credential: Credential | None = None) -> int | None:
    session = connector.start(credential)
    try:
        try:
            return int(get_bytes(connector, session, f"{base}/LATEST"))
        except NotFound:
            return None
    finally:
        connector.destroy(session)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(abstract_state, connector: Connector, base: str,
                       step: int | None = None,
                       credential: Credential | None = None,
                       shardings=None, verify: bool = True):
    """Restores into the structure of ``abstract_state`` (a tree of tensors,
    ``meta`` ones included).  Each leaf takes the manifest's shape and
    dtype and lands on its abstract leaf's device (the CPU for ``meta``).
    With ``shardings`` (a tree of the same structure whose leaves have a
    ``mesh`` and ``placements``: ``launch.cells.Sharding``), each rank reads
    one full leaf at a time onto the mesh's device, verifies its digest
    there, and keeps a copy of its shard as a ``DTensor``, on a mesh that may
    differ from the saver's (elastic restart): a rank holds one full leaf
    beside its shards, never the unsharded state.  Returns (state, step)."""
    session = connector.start(credential)
    try:
        if step is None:
            step = int(get_bytes(connector, session, f"{base}/LATEST"))
        root = f"{base}/step_{step}"
        manifest = json.loads(get_bytes(connector, session,
                                        f"{root}/manifest.json"))
        bundles_cache: dict[str, bytes] = {}

        def load(path: str, dev: torch.device):
            if path in manifest["objects"]:
                meta = manifest["objects"][path]
                data = get_bytes(connector, session,
                                 f"{root}/{meta['object']}")
            elif path in manifest["bundles"]:
                meta = manifest["bundles"][path]
                obj = meta["object"]
                if obj not in bundles_cache:
                    bundles_cache[obj] = get_bytes(connector, session,
                                                   f"{root}/{obj}")
                data = bundles_cache[obj][meta["offset"]:
                                          meta["offset"] + meta["length"]]
            else:
                raise NotFound(f"checkpoint object for {path}")
            return _to_device(data, dev), meta

        def check(paths, leaves):
            if verify:
                u8s = [leaves[p][0] for p in paths]
                for path, dig in zip(paths, _digests([u.device for u in u8s], u8s.__getitem__)):
                    if dig != leaves[path][1]["checksum"]:
                        raise IntegrityError(f"checksum mismatch restoring {path}")

        def typed(u8, meta):
            return u8.view(torch_dtype(meta["dtype"])).reshape(meta["shape"])

        placed = {p: sh for p, sh in flatten(shardings or {}).items() if sh is not None}
        restored, loaded = {}, {}
        for path, spec in flatten(abstract_state).items():
            if path not in placed:
                dev = torch.device("cpu") if spec.device.type == "meta" else spec.device
                loaded[path] = load(path, dev)
                continue
            # one full leaf at a time: every rank reads and verifies it, keeps
            # a copy of its shard (a view would keep the full leaf alive) and
            # drops the leaf before the next; nothing is sent
            sh = placed[path]
            leaf = {path: load(path, _mesh_device(sh.mesh))}
            check([path], leaf)
            full = distribute_tensor(typed(*leaf.pop(path)), sh.mesh, sh.placements,
                                     src_data_rank=None)
            restored[path] = DTensor.from_local(full.to_local().clone(), sh.mesh,
                                                sh.placements, run_check=False,
                                                shape=full.shape, stride=full.stride())
            del full
        check(list(loaded), loaded)
        restored.update((path, typed(*lm)) for path, lm in loaded.items())
        return unflatten(abstract_state, restored), step
    finally:
        connector.destroy(session)


class CheckpointManager:
    """Async checkpointing for the train loop.

    ``save_async`` digests every leaf on its device and copies it to the
    host before it returns, so the train step may update the state in
    place at once; a background thread then streams the objects through
    the Connector, as in the reference.  ``retain`` old checkpoints are
    garbage-collected.  ``timings`` holds one dict per save: leaves,
    objects, bytes, digest_s, d2h_s, write_s and verify_s.
    """

    def __init__(self, connector: Connector, base: str,
                 credential: Credential | None = None, retain: int = 3):
        self.connector = connector
        self.base = base
        self.credential = credential
        self.retain = retain
        self.timings: list[dict] = []
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._saved_steps: list[int] = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, state, step: int):
        self.wait()
        timings = {"step": step}
        leaves = snapshot(state, timings)

        def work():
            try:
                write_snapshot(leaves, self.connector, self.base, step,
                               credential=self.credential, timings=timings)
                self.timings.append(timings)
                self._saved_steps.append(step)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        while len(self._saved_steps) > self.retain:
            victim = self._saved_steps.pop(0)
            session = self.connector.start(self.credential)
            try:
                self.connector.command(session, "delete",
                                       f"{self.base}/step_{victim}")
            except NotFound:
                pass
            finally:
                self.connector.destroy(session)

    def restore_latest(self, abstract_state):
        step = latest_step(self.connector, self.base, self.credential)
        if step is None:
            return None, None
        return restore_checkpoint(abstract_state, self.connector, self.base,
                                  step, credential=self.credential)
