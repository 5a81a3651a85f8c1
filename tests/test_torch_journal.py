"""The port's write-ahead journal (``repro_torch.core.journal``) against the
JAX package's, on the CPU.

* the record frame is byte-compatible: the same record stream appended
  through each package's ``JournalFile`` gives byte-identical files, and
  the same ``begin_run``/``put``/``delete`` sequence through each package's
  ``JournaledStorage`` (numpy trees with sorted keys) too;
* each package's ``JournalFile.scan`` reads the other's WAL to the same
  records (ops, keys, offsets) and ``valid_end``, intact, with a torn tail
  (header or body cut short), and with a flipped payload or header byte
  (the same ``checksum`` damage);
* an fp32 STORE payload written by either decodes to equal numpy arrays in
  both (a tuple carry and a dict of leaves);
* ``read_payload`` raises the same typed faults on a torn or corrupted
  record; ``iter_epoch`` picks the same last epoch.
"""
import os
import pickle

import numpy as np
import pytest

from repro.core import journal as j_journal
from repro.core import storage as j_storage
from repro.core.faults import ChecksumError as JChecksumError
from repro.core.faults import TornRecordError as JTornRecordError
from repro_torch.core import journal
from repro_torch.core import storage
from repro_torch.core.faults import ChecksumError, TornRecordError

PKGS = {"port": journal, "ref": j_journal}


def _records(seed=0):
    """A record stream of every op: (op, key bytes, payload bytes)."""
    rng = np.random.default_rng(seed)
    dump = lambda x: pickle.dumps(x, protocol=pickle.HIGHEST_PROTOCOL)
    state = {"c": rng.standard_normal((2, 3)).astype(np.float32),
             "h": rng.standard_normal((2, 3)).astype(np.float32)}
    return [
        (journal.OP_BEGIN, b"", dump({"n": 12, "interval": 4})),
        (journal.OP_STORE, dump(0), dump(state)),
        (journal.OP_CURSOR, b"", dump(("forward", 1))),
        (journal.OP_STORE, dump(4), dump((state["h"], state["c"]))),
        (journal.OP_DELETE, dump(0), b""),
        (journal.OP_STORE, dump("__final__"), dump(state)),
        (journal.OP_END, b"", b""),
    ]


def _write(pkg, path, records, *, sync=None):
    jf = pkg.JournalFile(path)
    for op, key, payload in records:
        jf.append(op, key, payload, sync=sync)
    jf.close()


def _scan(pkg, path):
    jf = pkg.JournalFile(path)
    try:
        res = jf.scan()
    finally:
        jf.close()
    damage = None if res.damage is None else (res.damage.kind,
                                              res.damage.offset)
    recs = [(r.op, r.key, r.payload, r.start, r.payload_off, r.end)
            for r in res.records]
    return recs, res.valid_end, damage


def test_record_constants_are_the_reference_s():
    assert journal.MAGIC == j_journal.MAGIC == b"RJ1\x00"
    assert journal._HEADER.format == j_journal._HEADER.format == "<4sBIQII"
    assert journal.OP_NAMES == j_journal.OP_NAMES
    for op, key, payload in _records():
        assert journal._pack_header(op, key, payload) == \
            j_journal._pack_header(op, key, payload)


@pytest.mark.parametrize("sync", [None, False])
def test_same_records_give_byte_identical_files(tmp_path, sync):
    ours, ref = str(tmp_path / "port.log"), str(tmp_path / "ref.log")
    _write(journal, ours, _records(), sync=sync)
    _write(j_journal, ref, _records(), sync=sync)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def _damage(path, how):
    """Cut or corrupt a WAL the way a crash or bit rot would; returns the
    offset of the damaged record."""
    jf = journal.JournalFile(path)
    recs = jf.scan().records
    jf.close()
    last = recs[-2]          # the final STORE (its END follows)
    with open(path, "r+b") as f:
        if how == "torn-body":
            f.truncate(last.start + (last.end - last.start) // 2)
        elif how == "torn-header":
            f.truncate(last.start + 7)
        elif how == "flip-payload":
            f.seek(last.end - 1)
            b = f.read(1)
            f.seek(last.end - 1)
            f.write(bytes([b[0] ^ 0xFF]))
        elif how == "flip-length":
            off = last.start + 5 + 4        # the pay_len field
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x01]))
    return last.start


@pytest.mark.parametrize("writer", sorted(PKGS))
@pytest.mark.parametrize("how,kind", [
    (None, None), ("torn-body", "torn"), ("torn-header", "torn"),
    ("flip-payload", "checksum"), ("flip-length", "checksum")])
def test_each_package_scans_the_others_wal_alike(tmp_path, writer, how,
                                                 kind):
    path = str(tmp_path / "wal.log")
    _write(PKGS[writer], path, _records(1))
    at = _damage(path, how) if how else None
    ours = _scan(journal, path)
    ref = _scan(j_journal, path)
    assert ours == ref
    recs, valid_end, damage = ours
    if how is None:
        assert damage is None and len(recs) == 7
        assert valid_end == os.path.getsize(path)
    else:
        assert damage == (kind, at) and valid_end == at
        assert len(recs) == 5
    # the intact STORE payloads decode to the arrays that were written
    written = {pickle.loads(k): pickle.loads(p)
               for op, k, p in _records(1) if op == journal.OP_STORE}
    for op, key, payload, *_ in recs:
        if op == journal.OP_STORE:
            got = list(_leaves(pickle.loads(payload)))
            want = list(_leaves(written[key]))
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert type(x) is np.ndarray and x.dtype == np.float32
                np.testing.assert_array_equal(x, y)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


@pytest.mark.parametrize("how,port_err,ref_err", [
    ("flip-payload", ChecksumError, JChecksumError),
    ("flip-length", ChecksumError, JChecksumError),
    ("torn-body", TornRecordError, JTornRecordError)])
def test_read_payload_raises_the_same_typed_faults(tmp_path, how, port_err,
                                                   ref_err):
    path = str(tmp_path / "wal.log")
    _write(j_journal, path, _records(2))
    at = _damage(path, how)
    for pkg, err in ((journal, port_err), (j_journal, ref_err)):
        jf = pkg.JournalFile(path)
        try:
            with pytest.raises(err):
                jf.read_payload(at)
        finally:
            jf.close()


def test_iter_epoch_picks_the_same_last_epoch(tmp_path):
    path = str(tmp_path / "wal.log")
    _write(journal, path, _records(3) + _records(4)[:3])
    jf = journal.JournalFile(path)
    recs = jf.scan().records
    jf.close()
    ours = [(r.op, r.start) for r in journal.iter_epoch(recs)]
    ref = [(r.op, r.start) for r in j_journal.iter_epoch(recs)]
    assert ours == ref and len(ours) == 3


def _tree(i):
    rng = np.random.default_rng(10 + i)
    return {"a": rng.standard_normal(8).astype(np.float32),
            "b": np.arange(3, dtype=np.int32) + i}


def _journaled_sequence(make, directory):
    js = make("ram", journal=directory)
    js.begin_run({"n": 8, "fingerprint": "0badf00d"})
    js.put(0, _tree(0))
    js.put(4, (_tree(4)["a"], _tree(4)["a"] * 2))
    js.delete(0)
    js.put("__final__", _tree(8))
    js.close()
    return os.path.join(directory, "wal.log")


def test_journaled_storage_writes_the_reference_s_bytes(tmp_path):
    """The same begin_run/put/delete sequence of numpy trees through each
    package's JournaledStorage gives the same file, byte for byte, and each
    package re-hydrates the other's stores to equal arrays."""
    ours = _journaled_sequence(storage.make_backend, str(tmp_path / "p"))
    ref = _journaled_sequence(j_storage.make_backend, str(tmp_path / "r"))
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for make, d in ((storage.make_backend, "r"),
                    (j_storage.make_backend, "p")):
        js = make("ram", journal=str(tmp_path / d))
        rec = js.recover()
        assert rec.keys == (4, "__final__")
        assert rec.meta == {"n": 8, "fingerprint": "0badf00d"}
        a, b = js.get(4)
        np.testing.assert_array_equal(np.asarray(a), _tree(4)["a"])
        np.testing.assert_array_equal(np.asarray(b), _tree(4)["a"] * 2)
        final = js.get("__final__")
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(final[k]), _tree(8)[k])
        js.close()


def test_host_tensor_payload_decodes_as_numpy_in_the_reference(tmp_path):
    """A store handed over as frozen views of host tensors (a fused
    advance's chunk entry) is journaled as host numpy — the reference reads
    an fp32 tuple state back as plain arrays — while the inner store keeps
    the views by reference; a bf16 leaf is journaled as its raw bits."""
    import torch

    h = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    c = -h
    views = storage._frozen_views((h, c))
    js = storage.make_backend("ram", journal=str(tmp_path / "wal"))
    js.put(0, views)
    js.put(1, storage._frozen_views({"x": h.to(torch.bfloat16)}))
    kept = js.inner.get(0)
    assert kept[0] is views[0] and kept[1] is views[1]
    js.close()
    ref = j_storage.make_backend("ram", journal=str(tmp_path / "wal"))
    a, b = ref.get(0)
    assert type(a) is np.ndarray and a.dtype == np.float32
    np.testing.assert_array_equal(a, h.numpy())
    np.testing.assert_array_equal(b, c.numpy())
    ref.close()
    ours = storage.make_backend("ram", journal=str(tmp_path / "wal"))
    bits = ours.get(1)["x"]
    assert isinstance(bits, storage.Bits) and bits.dtype == torch.bfloat16
    assert torch.equal(storage._host_tensor(bits), h.to(torch.bfloat16))
    ours.close()
