"""Package-level rules of the PyTorch/CUDA port: it imports nothing of JAX or
of the JAX package, its entry points never fall back to the CPU, every
unported path raises ``NotImplementedError`` naming its ROADMAP item, and its
``MemoryConfig`` carries every field of the JAX one."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lazzaro_tpu.config import MemoryConfig as JaxConfig
from lazzaro_tpu_torch import MemoryConfig, MemoryIndex, MemorySystem
from lazzaro_tpu_torch.config import _UNPORTED
from lazzaro_tpu_torch.core.interfaces import EmbeddingProvider, LLMProvider
from lazzaro_tpu_torch.core.memory_shard import MemoryShard
from lazzaro_tpu_torch.core.providers import HashingEmbedder, HeuristicLLM
from lazzaro_tpu_torch.models.graph import Edge
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.parallel import make_mesh

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Every submodule of the port, and chip_smoke.py, import in a fresh
    interpreter without pulling in jax, flax or lazzaro_tpu."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import lazzaro_tpu_torch, chip_smoke
        names = [m.name for m in pkgutil.walk_packages(
            lazzaro_tpu_torch.__path__, "lazzaro_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "lazzaro_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 15 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_silent_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MemorySystem(enable_async=False, load_from_disk=False,
                     db_dir=str(tmp_path), verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MemoryIndex(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MemoryIndex(8, device="cuda")
    assert MemoryIndex(8, device="cpu").device.type == "cpu"


def test_masked_topk_takes_only_cpu_and_cuda_tensors():
    emb = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mt.masked_topk(emb, torch.ones(16, dtype=torch.bool, device="meta"),
                       torch.zeros((1, 8), device="meta"), 2)


def test_config_carries_every_jax_field():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(MemoryConfig)}
    assert port_fields == jax_fields


def _switched_on(name):
    value = getattr(MemoryConfig(), name)
    return not value if isinstance(value, bool) else 4


@pytest.mark.parametrize("name", [n for n, _, _ in _UNPORTED])
def test_unported_config_paths_raise(name, tmp_path):
    cfg = MemoryConfig(**{name: _switched_on(name)})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        MemorySystem(enable_async=False, load_from_disk=False,
                     db_dir=str(tmp_path), verbose=False, config=cfg,
                     device="cpu")


def test_unported_entry_points_raise(tmp_path):
    kw = dict(enable_async=False, verbose=False, device="cpu",
              db_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(("data", "model"), (4, 2), devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MemorySystem(load_from_disk=False, store=object(), **kw)
    (tmp_path / "nodes.parquet").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MemorySystem(load_from_disk=True, **kw)
    ms = MemorySystem(load_from_disk=False, **kw)
    for call in (lambda: ms.save_snapshot(str(tmp_path / "s")),
                 lambda: ms.load_snapshot(str(tmp_path / "s")),
                 lambda: ms.save_state(), lambda: ms.load_state()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    ms.close()


def test_slice_defaults_are_the_classic_path():
    """Defaults: the JAX defaults for serving, ingest and consolidation,
    fused serving, the fused dedup ingest and ``auto_consolidate``, with the
    classic lifecycle path, and they pass the ported-path check; a mesh with
    the fused ingest on raises, naming its ROADMAP item, and takes the
    classic ingest flags and ``auto_consolidate=False``."""
    cfg = MemoryConfig()
    assert cfg.serve_fused is True and cfg.serve_ragged is True
    assert cfg.ingest_fused is True and cfg.ingest_dedup_fused is True
    assert cfg.auto_consolidate is True and cfg.consolidate_every == 3
    for name in ("lifecycle_fused", "journal", "ingest_journal"):
        assert getattr(cfg, name) is False, name
    cfg.check_ported()
    kw = dict(enable_async=False, load_from_disk=False, verbose=False,
              db_dir="unused", mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(NotImplementedError,
                       match="Queue 1 item 21, sharded fused ingest"):
        MemorySystem(**kw)
    MemorySystem(config=MemoryConfig(ingest_fused=False,
                                     ingest_dedup_fused=False,
                                     auto_consolidate=False), **kw).close()


def test_shard_neighbors_follow_edge_inserts_and_deletes():
    """The per-node edge index answers get_neighbors as a scan of every
    edge would, through inserts, reinforcement, deletes and a weight floor."""
    rng = np.random.default_rng(0)
    shard = MemoryShard("work")
    ids = [f"n{i}" for i in range(12)]
    for _ in range(60):
        a, b = rng.choice(ids, 2)
        shard.add_edge(Edge(source=str(a), target=str(b),
                            weight=float(rng.random())))
    for key in list(shard.edges)[::3]:
        del shard.edges[key]
    shard.add_edge(Edge(source="n1", target="n1", weight=0.9))   # self-loop

    def scan(nid, floor):
        out = []
        for (src, tgt), e in shard.edges.items():
            if e.weight < floor:
                continue
            if src == nid:
                out.append(tgt)
            elif tgt == nid:
                out.append(src)
        return sorted(out)

    for nid in ids:
        for floor in (0.0, 0.5):
            assert sorted(shard.get_neighbors(nid, floor)) == scan(nid, floor)


def test_default_providers_satisfy_the_protocols():
    assert isinstance(HeuristicLLM(), LLMProvider)
    emb = HashingEmbedder(32)
    assert isinstance(emb, EmbeddingProvider)
    assert len(emb.embed("hello world")) == 32
    assert np.asarray(emb.batch_embed(["a b", "c d"])).shape == (2, 32)
