"""The port's verified dataset cache and loader CLI
(``repro_torch.graphs.datasets``) and ``window.stream_stats``, held
against the reference's.  No network: every url is a ``file://`` url into
``tmp_path``, and the cache is a ``tmp_path`` directory set through
``REPRO_DATASET_CACHE``.

  * ``fetch_dataset``: the first fetch writes the trust-on-first-use
    ``.sha256`` sidecar, later fetches verify against it, an explicit wrong
    ``sha256`` raises ``ChecksumError``, a fetch that fails mid-stream
    leaves only its ``.part`` file, and the reference reads the port's
    cache (one cache serves both packages);
  * ``load_named_dataset`` and the CLI ``main`` against the reference's on
    one gzipped SNAP-style edge list: the saved traces are equal member for
    member, and the printed line is the same;
  * exit code 2 on a missing file, a malformed file and a checksum
    mismatch; ``stream_stats`` equal to the reference's.
"""
import gzip
import hashlib
import io
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from repro.graphs import datasets as jdatasets
from repro.graphs import window as jwindow
from repro_torch.graphs import datasets, window

ROOT = Path(__file__).resolve().parents[1]


def _snap_gz(tmp_path, name="edges.txt.gz", rows=400, seed=5):
    """A gzipped SNAP-style edge list (comment header, tab-separated)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(10, 5_000, rows)
    v = rng.integers(10, 5_000, rows)
    path = tmp_path / name
    with gzip.open(path, "wt") as f:
        f.write("# Directed graph: synthetic\n# FromNodeId\tToNodeId\n"
                + "".join(f"{a}\t{b}\n" for a, b in zip(u, v)))
    return path


@pytest.fixture
def cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_DATASET_CACHE", str(cache))
    return cache


def test_registry_and_cache_dir_match_reference(cache, monkeypatch):
    assert datasets.DATASETS == jdatasets.DATASETS
    assert datasets.dataset_cache_dir() == str(cache)
    monkeypatch.delenv("REPRO_DATASET_CACHE")
    assert datasets.dataset_cache_dir() == jdatasets.dataset_cache_dir()
    assert datasets.dataset_cache_dir().endswith(
        os.path.join(".cache", "repro", "datasets"))


def test_fetch_dataset_verifies_through_the_sidecar(tmp_path, cache):
    src = _snap_gz(tmp_path)
    url = src.as_uri()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    path = datasets.fetch_dataset(url)
    assert path == str(cache / src.name)
    assert Path(path).read_bytes() == src.read_bytes()
    sidecar = Path(path + ".sha256")
    assert sidecar.read_text() == digest + "\n"        # trust on first use
    assert not Path(path + ".part").exists()
    assert datasets.fetch_dataset(url) == path          # verified, cached
    assert datasets.fetch_dataset(url, sha256=digest) == path
    # the reference reads the port's cache, sidecar and all
    assert jdatasets.fetch_dataset(url) == path
    with pytest.raises(datasets.ChecksumError, match="sha256 mismatch"):
        datasets.fetch_dataset(url, sha256="0" * 64)
    # a cached file that changed under its sidecar fails loudly, in both
    Path(path).write_bytes(b"1 2\n")
    with pytest.raises(datasets.ChecksumError):
        datasets.fetch_dataset(url)
    with pytest.raises(jdatasets.ChecksumError):
        jdatasets.fetch_dataset(url)
    assert Path(path).read_bytes() == b"1 2\n"         # left for inspection


def test_fetch_dataset_lands_through_a_part_file(tmp_path, cache,
                                                 monkeypatch):
    """A download that fails mid-stream leaves its ``.part`` file and no
    cached file; the next fetch renames a whole download into place."""
    src = _snap_gz(tmp_path)
    url = src.as_uri()
    real = urllib.request.urlopen

    class Broken(io.BytesIO):
        def read(self, *a):
            if self.tell():
                raise OSError("connection reset")
            return super().read(16)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda u: Broken(src.read_bytes()))
    with pytest.raises(OSError, match="reset"):
        datasets.fetch_dataset(url)
    target = cache / src.name
    assert not target.exists()
    assert (cache / (src.name + ".part")).stat().st_size == 16
    monkeypatch.setattr(urllib.request, "urlopen", real)
    assert datasets.fetch_dataset(url) == str(target)
    assert target.read_bytes() == src.read_bytes()
    assert not (cache / (src.name + ".part")).exists()


def test_load_named_dataset_matches_reference(tmp_path, cache):
    src = _snap_gz(tmp_path)
    kw = dict(window_frac=0.3, delta=0.5, seed=2, query_every=40)
    n, trace = datasets.load_named_dataset(src.as_uri(), **kw)
    jn, jt = jdatasets.load_named_dataset(src.as_uri(), **kw)
    assert n == jn and trace.n_queries == jt.n_queries > 0
    for col in ("kind", "src", "dst", "w", "t"):
        np.testing.assert_array_equal(getattr(trace, col), getattr(jt, col))
    # a registry name resolves through DATASETS to its url
    name = "tiny-test-graph"
    entry = (src.as_uri(), hashlib.sha256(src.read_bytes()).hexdigest())
    for mod in (datasets, jdatasets):
        mod.DATASETS[name] = entry
    try:
        got = datasets.load_named_dataset(name, **kw)[1]
        np.testing.assert_array_equal(got.src, jt.src)
    finally:
        for mod in (datasets, jdatasets):
            del mod.DATASETS[name]


@pytest.mark.parametrize("how", ["path", "url"])
def test_cli_writes_the_reference_trace(tmp_path, cache, capsys,
                                        monkeypatch, how):
    """``main`` against the reference's ``main``: the same version-2
    trace, member for member, and the same printed line."""
    src = _snap_gz(tmp_path)
    arg = str(src) if how == "path" else src.as_uri()
    argv = [arg, "trace.npz", "--window-frac", "0.4", "--delta", "0.5",
            "--seed", "3", "--query-every", "30", "--chunk-events", "64"]
    lines = []
    for mod, sub in ((datasets, "port"), (jdatasets, "ref")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert mod.main(argv) == 0
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] and "chunks of 64" in lines[0]
    with np.load(tmp_path / "port" / "trace.npz") as a, \
            np.load(tmp_path / "ref" / "trace.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 7
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_module_runs_as_a_script(tmp_path):
    src = _snap_gz(tmp_path)
    out = tmp_path / "t.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DATASET_CACHE=str(tmp_path / "cache"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.graphs.datasets", str(src),
         str(out)], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"{src}: n=") and out.exists()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.graphs.datasets",
         str(tmp_path / "missing.txt"), str(out)],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 2 and "error:" in r.stderr


def test_cli_exits_2_on_bad_input(tmp_path, cache, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2\n3\n")
    src = _snap_gz(tmp_path)
    datasets.fetch_dataset(src.as_uri())
    (cache / src.name).write_bytes(b"5 6\n")            # under its sidecar
    for arg in (str(tmp_path / "missing.txt"), str(bad), src.as_uri(),
                (tmp_path / "gone.txt.gz").as_uri()):
        with pytest.raises(SystemExit) as ei:
            datasets.main([arg, str(tmp_path / "out.npz")])
        assert ei.value.code == 2
        assert "error:" in capsys.readouterr().err
    assert not (tmp_path / "out.npz").exists()


@pytest.mark.parametrize("query_every", [0, 7])
def test_stream_stats_match_reference(query_every):
    rng = np.random.default_rng(query_every)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    w = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    kw = dict(window=60, delta=0.4, seed=1, query_every=query_every)
    log = window.sliding_window_stream(src, dst, w, **kw)
    jlog = jwindow.sliding_window_stream(src, dst, w, **kw)
    got = window.stream_stats(log)
    assert got == jwindow.stream_stats(jlog)
    assert got["dels"] > 0 and (got["queries"] > 0) == bool(query_every)
    assert got["events"] == got["adds"] + got["dels"] + got["queries"]
