"""The port's ``data/row_iter.py`` (``BasicRowIter``, ``DiskRowIter``,
``create_row_block_iter``), ``concurrency/thread_group.py`` and
``utils/common.py`` against the JAX package's, on the same inputs: the
cases of ``tests/test_data.py:272, :285``, ``tests/test_concurrency.py``
(the blocking queue, ``ThreadGroup``, ``TimerThread``) and
``tests/test_utils.py:65-90``, each run through both packages. The row
iterators give the same rows and ``num_col``, and ``DiskRowIter``'s cache
file and its meta are byte-equal across the packages."""

import threading
import time

import numpy as np
import pytest

import dmlc_core_tpu.concurrency as jax_conc
import dmlc_core_tpu.data as jax_data
import dmlc_core_tpu.utils.common as jax_common
import dmlc_core_tpu_torch.concurrency as port_conc
import dmlc_core_tpu_torch.data as port_data
import dmlc_core_tpu_torch.utils.common as port_common
from dmlc_core_tpu.utils.logging import Error as JaxError
from dmlc_core_tpu_torch.utils.logging import Error

DATA = {"jax": jax_data, "port": port_data}
CONC = {"jax": (jax_conc, JaxError), "port": (port_conc, Error)}
COMMON = {"jax": jax_common, "port": port_common}


def rows_of(it):
    out = []
    for b in it:
        out.append([np.asarray(getattr(b, k)).tolist() if getattr(b, k) is not None else None
                    for k in ("offset", "label", "index", "value", "weight")])
    return out


def test_basic_row_iter_matches_jax(tmp_path):
    """As ``test_basic_row_iter``: one eager block of both rows, num_col
    10, replayed after ``before_first``, the same block in both
    packages."""
    p = tmp_path / "x.libsvm"
    p.write_bytes(b"1 0:1 9:2\n0 4:1\n")
    got = {}
    for pkg, mod in DATA.items():
        it = mod.create_row_block_iter(str(p), type="libsvm")
        assert it.num_col() == 10
        blk = it.next()
        assert blk.size == 2 and it.next() is None
        it.before_first()
        assert it.next().size == 2
        it.before_first()
        got[pkg] = rows_of(it)
    assert got["port"] == got["jax"]


def _write_rows(p, n=100):
    with open(p, "wb") as f:
        for i in range(n):
            f.write(b"%d %d:1.0\n" % (i % 2, i % 7))


@pytest.mark.parametrize("fmt", ["libsvm", "rowrec"])
def test_disk_row_iter_cache_is_the_jax_cache(tmp_path, fmt):
    """As ``test_disk_row_iter_cache_epochs``: a ``#cachefile`` URI builds
    the cache on first use, replays 100 rows an epoch and is reused by a
    second iterator; the cache file and its meta are the JAX package's
    bytes, and the epochs' rows are equal (libsvm text, and a rowrec
    file)."""
    src = tmp_path / "x.libsvm"
    _write_rows(src)
    uri, kind = str(src), "libsvm"
    if fmt == "rowrec":
        from dmlc_core_tpu_torch import tools

        assert tools.main(["rowrec", str(src), str(tmp_path / "x.rec"), "--format",
                           "libsvm"]) == 0
        uri, kind = str(tmp_path / "x.rec"), "rowrec"
    got = {}
    for pkg, mod in DATA.items():
        cache = tmp_path / f"{pkg}.cache"
        it = mod.create_row_block_iter(f"{uri}#{cache}", type=kind)
        assert cache.exists()
        rows1 = rows_of(it)
        it.before_first()
        rows2 = rows_of(it)
        assert sum(len(r[1]) for r in rows1) == 100 and rows1 == rows2
        assert it.num_col() == 7
        it.close()
        it2 = mod.create_row_block_iter(f"{uri}#{cache}", type=kind)
        assert rows_of(it2) == rows1
        it2.close()
        got[pkg] = (cache.read_bytes(), (tmp_path / f"{pkg}.cache.meta").read_bytes(), rows1)
    assert got["port"] == got["jax"]


def test_a_cachefile_with_an_epoch_shuffle_raises_in_both(tmp_path):
    """An epoch shuffle would be frozen into the cache: both packages
    refuse it with the same text."""
    uri = f"{tmp_path}/x.rec?index={tmp_path}/x.idx&shuffle=batch#{tmp_path}/c"
    texts = []
    for mod, err in ((jax_data, JaxError), (port_data, Error)):
        with pytest.raises(err, match="would freeze") as info:
            mod.create_row_block_iter(uri)
        texts.append(str(info.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_concurrent_blocking_queue_kill(pkg):
    """A pop blocked on an empty queue returns None once the queue is
    killed, and a killed queue stays killed."""
    q = CONC[pkg][0].ConcurrentBlockingQueue(maxsize=4)
    q.put(1)
    assert q.pop() == 1
    results = []
    t = threading.Thread(target=lambda: results.append(q.pop()))
    t.start()
    time.sleep(0.05)
    q.signal_for_kill()
    t.join(timeout=2)
    assert not t.is_alive() and results == [None]
    assert q.pop() is None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_thread_group_lifecycle(pkg):
    """As ``test_thread_group_lifecycle``: named threads, a second launch
    of a running name raises, cooperative shutdown joins them all."""
    mod, err = CONC[pkg]
    g = mod.ThreadGroup()
    counter = {"n": 0}

    def worker():
        while not g.shutdown_requested.wait(0.01):
            counter["n"] += 1

    g.launch("w1", worker)
    g.launch("w2", worker)
    assert g.count() == 2
    with pytest.raises(err, match="already running") as info:
        g.launch("w1", worker)
    assert str(info.value) == "thread 'w1' already running in group"
    time.sleep(0.05)
    g.request_shutdown_all()
    assert g.join_all(timeout=2)
    assert counter["n"] > 0 and g.count() == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_timer_thread_fires_periodically(pkg):
    hits = []
    with CONC[pkg][0].TimerThread(0.02, lambda: hits.append(1)):
        time.sleep(0.13)
    n = len(hits)
    assert n >= 3
    time.sleep(0.05)
    assert len(hits) == n  # stopped


def test_split_parse_bool_and_hash_combine_match_jax():
    """``split_string``, ``parse_bool`` and ``hash_combine`` give the JAX
    package's answers, errors included."""
    for s, d in (("a,b,,c", ","), ("", ","), ("a,b,", ","), (",", ","), ("x", ";")):
        assert port_common.split_string(s, d) == jax_common.split_string(s, d)
    assert port_common.split_string("a,b,,c", ",") == ["a", "b", "", "c"]
    for s in ("1", "true", " YES ", "on", "0", "false", "No", "off", ""):
        assert port_common.parse_bool(s) is jax_common.parse_bool(s)
    with pytest.raises(ValueError, match="not a boolean string"):
        port_common.parse_bool("maybe")
    h = [0, 0]
    for v in (1, 2, 3, 2**40, 7):
        h = [port_common.hash_combine(h[0], v), jax_common.hash_combine(h[1], v)]
        assert h[0] == h[1] and 0 <= h[0] < 2**64
    assert port_common.hash_combine(0, 1) != port_common.hash_combine(port_common.hash_combine(0, 1), 2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_thread_exceptions(pkg):
    """``run_parallel`` rethrows a worker's exception on the caller, and
    ``ThreadException`` keeps the first of several."""
    mod = COMMON[pkg]

    def bad():
        raise ValueError("worker died")

    with pytest.raises(ValueError, match="worker died"):
        mod.run_parallel([bad, lambda: None])
    exc = mod.ThreadException()
    for tag in ("a", "b"):
        t = threading.Thread(target=exc.wrap(lambda x: (_ for _ in ()).throw(RuntimeError(x))),
                             args=(tag,))
        t.start()
        t.join()
    with pytest.raises(RuntimeError, match="a"):
        exc.rethrow()
