"""The port's write-ahead log and ingest journal against the JAX package's:
the cases of ``tests/test_native.py``'s WAL section and the ingest-journal
cases of ``tests/test_fault_injection.py`` that need no fault injector, on
both packages, with the bytes each writes replayed by the other."""

import json
import os

import pytest

from lazzaro_tpu import native as jax_native
from lazzaro_tpu.reliability.journal import IngestJournal as JaxJournal
from lazzaro_tpu_torch import native
from lazzaro_tpu_torch.native import build as build_mod
from lazzaro_tpu_torch.reliability.journal import IngestJournal

LOGS = {"port": native.WriteAheadLog, "jax": jax_native.WriteAheadLog}
JOURNALS = {"port": IngestJournal, "jax": JaxJournal}


@pytest.mark.parametrize("pkg", sorted(LOGS))
def test_wal_roundtrip(pkg, tmp_path):
    wal = LOGS[pkg](str(tmp_path / "j.wal"))
    payloads = [b"first", b"", b"third record with more bytes"]
    for p in payloads:
        wal.append(p)
    assert wal.replay() == payloads
    wal.reset()
    assert wal.replay() == []


@pytest.mark.parametrize("pkg", sorted(LOGS))
def test_wal_missing_file(pkg, tmp_path):
    assert LOGS[pkg](str(tmp_path / "nope.wal")).replay() == []


@pytest.mark.parametrize("pkg", sorted(LOGS))
def test_wal_torn_tail_discarded(pkg, tmp_path):
    path = str(tmp_path / "torn.wal")
    wal = LOGS[pkg](path)
    wal.append(b"good-1")
    wal.append(b"good-2")
    size_before = os.path.getsize(path)
    wal.append(b"the-final-record-that-gets-torn")
    with open(path, "r+b") as f:                 # crash mid-append
        f.truncate(size_before + 7)
    assert wal.replay() == [b"good-1", b"good-2"]
    with open(path, "rb") as f:
        assert native.unframe(f.read()) == [b"good-1", b"good-2"]


@pytest.mark.parametrize("pkg", sorted(LOGS))
def test_wal_corrupt_payload_discarded(pkg, tmp_path):
    path = str(tmp_path / "corrupt.wal")
    wal = LOGS[pkg](path)
    wal.append(b"alpha")
    wal.append(b"beta")
    with open(path, "r+b") as f:                 # flip a byte in record 2
        data = bytearray(f.read())
        data[-1] ^= 0xFF
        f.seek(0)
        f.write(data)
    assert wal.replay() == [b"alpha"]


def test_wal_native_and_plain_framing_interchange(tmp_path):
    """The native log's bytes are the plain framing's, and each replays
    the other's records."""
    path = str(tmp_path / "mixed.wal")
    payloads = [b"written-native", b"", bytes(range(256)) * 3]
    wal = native.WriteAheadLog(path, fsync=False)
    for p in payloads:
        wal.append(p)
    with open(path, "rb") as f:
        raw = f.read()
    assert raw == b"".join(native.frame(p) for p in payloads)
    assert native.unframe(raw) == payloads
    with open(path, "ab") as f:
        f.write(native.frame(b"written-plain"))
    assert wal.replay() == payloads + [b"written-plain"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_wal_bytes_replay_across_packages(writer, reader, tmp_path):
    """A log written by one package replays in the other, and the same
    appends leave the same bytes."""
    payloads = [json.dumps({"content": f"turn {i}", "salience": 0.5})
                .encode() for i in range(5)] + [b""]
    path = str(tmp_path / f"{writer}.wal")
    wal = LOGS[writer](path, fsync=False)
    for p in payloads:
        wal.append(p)
    assert LOGS[reader](path).replay() == payloads
    other = str(tmp_path / f"{reader}.wal")
    for p in payloads:
        LOGS[reader](other, fsync=False).append(p)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def test_wal_without_a_compiler_raises(monkeypatch, tmp_path):
    """No silent Python fallback: with no library built and no g++, the log
    refuses to open."""
    monkeypatch.setattr(build_mod, "_lib", None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(build_mod.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.WriteAheadLog(str(tmp_path / "x.wal"))


@pytest.mark.parametrize("pkg", sorted(JOURNALS))
def test_ingest_journal_append_commit_replay(pkg, tmp_path):
    J = JOURNALS[pkg]
    p = str(tmp_path / "ing.wal")
    j = J(p)
    s1 = j.append([{"content": "a"}])
    s2 = j.append([{"content": "b"}, {"content": "c"}])
    assert (s1, s2) == (1, 2)
    j2 = J(p)                                     # crash + reopen
    assert [s for s, _ in j2.pending()] == [1, 2]
    j2.commit(s1)
    j3 = J(p)
    assert [f for _, f in j3.pending()] == [[{"content": "b"},
                                             {"content": "c"}]]
    j3.commit(j3.last_seq)                        # retires all: compacts
    assert os.path.getsize(p) == 0
    j4 = J(p)
    s3 = j4.append([{"content": "d"}])
    with open(p, "ab") as f:
        f.write(b"\x31WZL\x99garbage")            # torn tail record
    j5 = J(p)
    assert [s for s, _ in j5.pending()] == [s3]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_ingest_journal_replays_across_packages(writer, reader, tmp_path):
    """Batches, commits and overlay records written by one package read the
    same in the other; ``lag`` and ``oldest_age`` agree."""
    p = str(tmp_path / "ing.wal")
    j = JOURNALS[writer](p)
    for i in range(4):
        j.append([{"content": f"fact {i}", "salience": 0.6}])
    j.register_overlay("tenant-x")
    j.commit(2)
    got = JOURNALS[reader](p)
    want = JOURNALS[writer](p)
    assert got.pending() == want.pending() == [
        (3, [{"content": "fact 2", "salience": 0.6}]),
        (4, [{"content": "fact 3", "salience": 0.6}])]
    assert got.overlay_tenants == want.overlay_tenants == {"tenant-x"}
    assert got.last_seq == want.last_seq == 4
    assert got.lag(2) == want.lag(2) == 2
    assert got.oldest_age(0) == want.oldest_age(0) == 0.0
    got.commit(got.last_seq)                      # compaction keeps overlays
    assert JOURNALS[writer](p).overlay_tenants == {"tenant-x"}
    assert JOURNALS[writer](p).pending() == []


def test_ingest_journal_lag_and_age_follow_appends(tmp_path):
    j = IngestJournal(str(tmp_path / "ing.wal"))
    s1 = j.append([{"content": "a"}])
    j.append([{"content": "b"}])
    assert j.lag(0) == 2 and j.lag(s1) == 1
    now = j._append_ts[s1] + 5.0
    assert j.oldest_age(0, now=now) == pytest.approx(5.0)
    assert j.pending_count == 2 and j.pending_facts == 2
    j.reset()
    assert j.pending() == [] and os.path.getsize(j.path) == 0
