"""Binary checkpoint of the device arena (index-scale save and restore),
``lazzaro_tpu/core/checkpoint.py`` byte for byte.

The row store (``core.store``) keeps per-node rows, which at a million rows
means Python objects per row on every reload. This is the index-scale
complement: one bulk device-to-host copy per column, written as raw numpy
arrays (``.npz``) with a JSON sidecar for the host bookkeeping (id maps,
tenant and shard vocabularies, epoch). bf16 columns go through ``uint16``
with the tag ``"bfloat16"`` (the npy format has no bf16 descriptor; torch
views the same bits as ``int16``).

Layout: ``ckpt_dir/CURRENT`` names the live version directory
``v<N>/`` (``arrays.npz``, ``meta.json``, ``checksums.json``). A save
stages the payload in a hidden directory, fsyncs it, renames it into place
and only then flips ``CURRENT`` atomically; superseded versions are pruned
after the flip. Every load verifies the payload's CRCs and raises
:class:`CheckpointCorrupt` rather than loading garbage.

A load rebuilds a ``MemoryIndex`` wholesale: each column goes to the device
in one upload (under a mesh, each shard's rows to their owner), the free
lists come from the alive masks, the edge-slot map from the live edge rows,
with nothing per row in Python but the id list itself. The port runs one
process, so the JAX package's rank-0 gate and barriers reduce to the
single-process case; the pod-sharded index's checkpoint
(``save_sharded_index``) waits for ``ShardedMemoryIndex`` (ROADMAP Queue 1
item 21). A checkpoint holding a section of a serving mode the port lacks
raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.core.index import MemoryIndex, _EdgeSlotMap
from lazzaro_tpu_torch.reliability import faults
from lazzaro_tpu_torch.reliability.errors import CheckpointCorrupt

_ARENA_COLS = ("emb", "salience", "timestamp", "last_accessed", "access_count",
               "type_id", "shard_id", "tenant_id", "alive", "is_super")
_EDGE_COLS = ("src", "tgt", "weight", "co", "last_updated", "alive", "tenant_id")

FORMAT_VERSION = 1

# meta sections of the JAX package's serving modes -> the ROADMAP item that
# ports them
_UNPORTED_SECTIONS = (("pq", "Queue 1 item 15, PQ"),
                      ("tier", "Queue 1 item 17, tiering"),
                      ("paged", "Queue 1 item 16, paged arena"),
                      ("semantic_cache", "Queue 1 item 18, semantic cache"))


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A device column as ``(numpy array, dtype tag)``: one copy to the
    host; bf16 as its ``uint16`` bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _tensor(a: np.ndarray, tag: str) -> torch.Tensor:
    """A loaded column as a host tensor of its saved dtype, sharing the
    loaded array's memory where it is writable (the state is updated in
    place)."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.view(torch.bfloat16) if tag == "bfloat16" else t


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_crc(path: str) -> int:
    """crc32 of a file's bytes, streamed (the npz payload can be GBs)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _verify_version_dir(vdir: str) -> None:
    """Check every payload file against the ``checksums.json`` written
    before the commit rename; a mismatch (torn write, bit rot, truncation)
    raises :class:`CheckpointCorrupt`. A checkpoint without the sidecar
    still loads (its decode errors are typed in :func:`_read_versioned`)."""
    sums_path = os.path.join(vdir, "checksums.json")
    try:
        with open(sums_path) as f:
            sums = json.load(f)
    except FileNotFoundError:
        return
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(
            f"unreadable checksum sidecar {sums_path}: {e}") from e
    for fname, want in sums.items():
        fpath = os.path.join(vdir, fname)
        try:
            got = _file_crc(fpath)
        except OSError as e:
            raise CheckpointCorrupt(
                f"checkpoint payload {fpath} unreadable: {e}") from e
        if got != int(want):
            raise CheckpointCorrupt(
                f"checkpoint payload {fpath} failed its checksum "
                f"(crc32 {got:#010x} != recorded {int(want):#010x}) — "
                f"torn or corrupted write; refusing to load")


def _write_versioned(ckpt_dir: str, arrays: Dict[str, np.ndarray],
                     meta: Dict) -> None:
    """Stage ``arrays.npz`` + ``meta.json`` + ``checksums.json`` into a new
    version directory, fsync the payload and the directories around the
    rename, flip ``CURRENT``, prune the superseded versions."""
    os.makedirs(ckpt_dir, exist_ok=True)
    cur = _read_current(ckpt_dir)
    next_n = int(cur[1:]) + 1 if cur else 1
    while os.path.exists(os.path.join(ckpt_dir, f"v{next_n}")):
        next_n += 1
    vname = f"v{next_n}"
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".stage-")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        sums = {"arrays.npz": _file_crc(os.path.join(tmp, "arrays.npz")),
                "meta.json": _file_crc(os.path.join(tmp, "meta.json"))}
        with open(os.path.join(tmp, "checksums.json"), "w") as f:
            json.dump(sums, f)
            f.flush()
            os.fsync(f.fileno())
        # the rename alone does not make the payload durable
        _fsync_path(os.path.join(tmp, "arrays.npz"))
        _fsync_path(tmp)
        os.replace(tmp, os.path.join(ckpt_dir, vname))
        _fsync_path(ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    fd, ptr_tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=".cur-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(vname)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, _current_path(ckpt_dir))
        _fsync_path(ckpt_dir)
    except BaseException:
        if os.path.exists(ptr_tmp):
            os.unlink(ptr_tmp)
        raise
    for entry in os.listdir(ckpt_dir):
        if entry != vname and (entry.startswith("v") or entry.startswith(".stage-")):
            shutil.rmtree(os.path.join(ckpt_dir, entry), ignore_errors=True)
    # Fault point: the armed hook corrupts the COMMITTED payload after the
    # flip, a torn write the fsync chain failed to make durable.
    faults.fire("checkpoint.torn", dir=os.path.join(ckpt_dir, vname))


def _read_versioned(ckpt_dir: str):
    cur = _read_current(ckpt_dir)
    if cur is None:
        raise FileNotFoundError(f"no checkpoint at {ckpt_dir} (missing CURRENT)")
    vdir = os.path.join(ckpt_dir, cur)
    _verify_version_dir(vdir)
    try:
        with open(os.path.join(vdir, "meta.json")) as f:
            meta = json.load(f)
        return np.load(os.path.join(vdir, "arrays.npz")), meta
    except (CheckpointCorrupt, FileNotFoundError):
        raise
    except Exception as e:             # noqa: BLE001 — typed re-raise
        # a torn npz raises zipfile.BadZipFile, a torn sidecar a JSON error:
        # every decode failure surfaces as the one typed error
        raise CheckpointCorrupt(
            f"checkpoint {vdir} failed to decode: {e}") from e


def _current_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "CURRENT")


def _read_current(ckpt_dir: str) -> Optional[str]:
    try:
        with open(_current_path(ckpt_dir)) as f:
            name = f.read().strip()
        return name or None
    except FileNotFoundError:
        return None


def read_meta(ckpt_dir: str) -> Dict:
    """The CURRENT version's ``meta.json`` alone, without the payload."""
    cur = _read_current(ckpt_dir)
    if cur is None:
        raise FileNotFoundError(f"no CURRENT checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, cur, "meta.json")) as f:
        return json.load(f)


def save_index(index: MemoryIndex, ckpt_dir: str,
               extra_meta: Optional[Dict] = None) -> None:
    """Write a new versioned snapshot of ``index`` under ``ckpt_dir`` and
    flip ``CURRENT`` atomically (a crash at any point leaves the previous
    snapshot readable). Under a mesh the arena columns are the shards'
    rows in global order."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    with index._lock:
        for col in _ARENA_COLS:
            arrays[f"arena_{col}"], dtypes[f"arena_{col}"] = _host(
                index._column(col))
        for col in _EDGE_COLS:
            arrays[f"edge_{col}"], dtypes[f"edge_{col}"] = _host(
                getattr(index.edge_state, col))
        # the id map as two aligned columns, not a JSON dict
        ids = list(index.id_to_row.keys())
        arrays["node_rows"] = np.asarray([index.id_to_row[i] for i in ids],
                                         np.int64)
        meta = {
            "format_version": FORMAT_VERSION,
            "dim": index.dim,
            "dtype": ("bfloat16" if index.dtype == torch.bfloat16
                      else str(index.dtype).replace("torch.", "")),
            "epoch": index.epoch,
            "column_dtypes": dtypes,
            "node_ids": ids,
            "tenants": index._tenants,
            "shards": index._shards,
            "counters": {"link_pool_overflows": index.link_pool_overflows},
        }
    if extra_meta:
        meta.update(extra_meta)
    _write_versioned(ckpt_dir, arrays, meta)


def load_index(ckpt_dir: str, mesh=None, shard_axis: str = "data",
               **index_kwargs) -> MemoryIndex:
    """Rebuild a ``MemoryIndex`` from the snapshot ``CURRENT`` points at.
    ``index_kwargs`` go to the constructor (``device``, the serving
    settings, ``int8_serving`` and ``coarse_slack``, ``telemetry``): the
    int8 shadow is never saved, and an index loaded with ``int8_serving``
    rebuilds it from the loaded arena at its first search. With ``mesh`` the rows are split over its
    devices (the saved row count must divide by the mesh size, as a
    mesh-created index guarantees); ``shard_axis`` must be its axis."""
    if mesh is not None and mesh.axis_names[0] != shard_axis:
        raise ValueError(f"load_index: the mesh's axis is "
                         f"{mesh.axis_names[0]!r}, not {shard_axis!r}")
    data, meta = _read_versioned(ckpt_dir)
    if meta.get("kind") == "sharded":
        raise ValueError(f"{ckpt_dir} is a sharded-index checkpoint "
                         f"(ShardedMemoryIndex, ROADMAP Queue 1 item 21)")
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta['format_version']}")
    for section, item in _UNPORTED_SECTIONS:
        if section in meta:
            raise NotImplementedError(
                f"checkpoint {ckpt_dir} holds a {section!r} section: not "
                f"ported to lazzaro_tpu_torch yet (ROADMAP {item})")
    dtypes = meta["column_dtypes"]
    arena = {c: data[f"arena_{c}"] for c in _ARENA_COLS}
    edges = {c: data[f"edge_{c}"] for c in _EDGE_COLS}

    index = MemoryIndex(meta["dim"], capacity=1, edge_capacity=1,
                        dtype=meta["dtype"], epoch=meta["epoch"], mesh=mesh,
                        **index_kwargs)
    if mesh is None:
        index.state = S.ArenaState(**{
            c: _tensor(a, dtypes[f"arena_{c}"]).to(index.device)
            for c, a in arena.items()})
    else:
        total = arena["salience"].shape[0]
        if total % mesh.size:
            raise ValueError(f"{total} saved rows do not split over "
                             f"{mesh.size} shards")
        local_n = total // mesh.size
        index.shards = [S.ArenaState(**{
            c: _tensor(a[p * local_n:(p + 1) * local_n],
                       dtypes[f"arena_{c}"]).to(dev)
            for c, a in arena.items()}) for p, dev in enumerate(mesh.devices)]
    index.edge_state = S.EdgeState(**{
        c: _tensor(a, dtypes[f"edge_{c}"]).to(index.device)
        for c, a in edges.items()})

    node_rows = data["node_rows"].astype(np.int64)
    node_ids = np.asarray(meta["node_ids"], object)
    index.id_to_row = dict(zip(node_ids.tolist(), node_rows.tolist()))
    index.row_to_id = dict(zip(node_rows.tolist(), node_ids.tolist()))
    index._tenants = {k: int(v) for k, v in meta["tenants"].items()}
    index._shards = {k: int(v) for k, v in meta["shards"].items()}
    index.link_pool_overflows = int(
        meta.get("counters", {}).get("link_pool_overflows", 0))

    # Free lists by set difference, descending (the lowest row pops first,
    # as in a fresh index).
    cap = arena["salience"].shape[0] - 1
    index._free_rows = np.setdiff1d(np.arange(cap, dtype=np.int64),
                                    node_rows)[::-1].tolist()
    sup_rows = np.flatnonzero(arena["is_super"][:cap] & arena["alive"][:cap])
    index._super_rows = {int(r) for r in sup_rows}
    index._super_rows_frozen = tuple(sorted(index._super_rows))

    # Edge bookkeeping from the LIVE slots only, through a dense row -> id
    # table.
    ecap = edges["src"].shape[0] - 1
    live_slots = np.flatnonzero(edges["alive"][:ecap])
    id_by_row = np.full((cap + 1,), None, object)
    id_by_row[node_rows] = node_ids
    src_ids = id_by_row[edges["src"][live_slots]]
    tgt_ids = id_by_row[edges["tgt"][live_slots]]
    index.edge_slots = _EdgeSlotMap({
        (s, t): int(slot)
        for s, t, slot in zip(src_ids.tolist(), tgt_ids.tolist(),
                              live_slots.tolist())
        if s is not None and t is not None})
    index._free_edge_slots = np.setdiff1d(
        np.arange(ecap, dtype=np.int64),
        np.asarray(sorted(index.edge_slots.values()), np.int64))[::-1].tolist()

    tenant_per_node = arena["tenant_id"][node_rows]
    index.tenant_nodes = {t: set(node_ids[tenant_per_node == tid].tolist())
                          for t, tid in index._tenants.items()}
    return index
