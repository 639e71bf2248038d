"""The repo-root entry points (bench.py, chip_smoke.py) and their helpers,
run here on the CPU at small sizes: the phases' control flow and checks,
the refusal to measure without a GPU, the benchmark's SNR gate and the
compile-cache location."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


class TestCompileCache:
    def test_env_var_left_alone(self, monkeypatch):
        import jax
        from grtpu.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        import jax
        from grtpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = compile_cache.enable_compile_cache()
            assert got == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestGpuRequired:
    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_refuses_cpu_backend(self, script, tmp_path):
        """With only a CPU backend the script exits nonzero at its device
        check and prints no result line."""
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                           capture_output=True, text=True, env=env,
                           cwd=tmp_path, timeout=120)
        assert r.returncode != 0
        assert "no GPU" in r.stderr
        assert not [l for l in r.stdout.splitlines() if l.startswith("{")]

    def test_smoke_alone_fails(self, tmp_path):
        """chip_smoke.py in a directory without the rest of the repo."""
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, env=env,
                           cwd=tmp_path, timeout=120)
        assert r.returncode != 0
        assert not r.stdout.strip()


BENCH_SCRIPTS = sorted(
    os.path.join("benchmarks", n)
    for n in os.listdir(os.path.join(ROOT, "benchmarks"))
    if n.endswith("_bench.py"))


class TestChainBenches:
    @pytest.mark.parametrize("script", BENCH_SCRIPTS)
    def test_refuses_cpu_backend(self, script):
        """Every chain bench exits nonzero at its device check on a CPU
        backend, before it measures or prints anything."""
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, script], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=120)
        assert r.returncode != 0
        assert "no GPU" in r.stderr
        assert not [l for l in r.stdout.splitlines() if l.startswith("{")]

    def test_emit_needs_setup(self, monkeypatch):
        from benchmarks import common

        monkeypatch.setattr(common, "_DEVICE", None)
        with pytest.raises(RuntimeError, match="setup"):
            common.emit({"metric": "x"})

    def test_emit_names_the_device(self, monkeypatch, capsys):
        import json

        from benchmarks import common

        dev = {"platform": "gpu", "kind": "K", "count": 1}
        monkeypatch.setattr(common, "_DEVICE", dev)
        common.emit({"metric": "x", "value": 1})
        rec = json.loads(capsys.readouterr().out)
        assert rec == {"metric": "x", "value": 1, "device": dev}

    @pytest.mark.parametrize("lines,rc,error", [
        (['{"metric": "a", "device": {"platform": "gpu"}}'], 0, None),
        (['{"metric": "a"}'], 0, "a record names no device"),
        ([], 0, "no JSON output"),
        (['{"metric": "a", "device": {"platform": "gpu"}}'], 1,
         "nonzero rc"),
    ])
    def test_run_chains_keeps_only_device_records(self, monkeypatch, lines,
                                                  rc, error):
        from benchmarks import run_chains

        def fake_run(*a, **k):
            return subprocess.CompletedProcess(a, rc, "\n".join(lines), "")

        monkeypatch.setattr(run_chains.subprocess, "run", fake_run)
        recs, diag = run_chains.run_one("x_bench.py", 10)
        if error is None:
            assert diag is None and recs[0]["device"]["platform"] == "gpu"
        else:
            assert recs is None and diag["error"] == error


class TestBenchGate:
    def _res(self, name, sec, snr):
        return {"config": name, "seconds": sec, "snr_db": snr}

    def test_no_passing_config_raises(self):
        with pytest.raises(RuntimeError, match="no config reached"):
            bench.pick([self._res("a", 1.0, 49.9), self._res("b", 0.5, 10)])

    def test_fastest_passing_config_wins(self):
        got = bench.pick([self._res("fast-bad", 0.1, 30.0),
                          self._res("slow-ok", 2.0, 90.0),
                          self._res("mid-ok", 1.0, 55.0)])
        assert got["config"] == "mid-ok"

    def test_unknown_device_has_no_peaks(self):
        with pytest.raises(KeyError, match="no published peaks"):
            bench.peaks_for("Some Other Card")
        assert bench.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12

    @pytest.mark.parametrize("config", bench.CONFIGS)
    def test_every_form_meets_gate_small(self, config):
        """Each bench form at a small width, 4 stages: SNR vs float64."""
        import jax.numpy as jnp

        taps, x = bench.taps_and_input(2, 4096)
        fn = bench.compile_config(config, taps, 4, x.shape)
        y = np.asarray(fn(jnp.asarray(x)))
        ref = bench.reference_chain(x, taps, 4)
        assert y.shape == x.shape
        assert bench.snr_db(y, ref) >= bench.SNR_GATE_DB


class TestSmokePhasesSmall:
    """chip_smoke's phases at a tiny size on the CPU: the same graphs,
    executors and checks the card runs at full size."""

    def test_wbfm(self):
        res = chip_smoke.phase_wbfm(nchan=2, nsamp=4096, chunk=1024)
        assert res["ok"], res["check"]
        assert res["audio"].shape == (2, 512)

    def test_dmr(self):
        res = chip_smoke.phase_dmr(nchan=2, nbursts=2)
        assert res["ok"], res["check"]

    def test_fir(self):
        res = chip_smoke.phase_fir(npipes=2, nsamples=4096, nstages=2)
        assert res["ok"], res["check"]

    def test_ingest(self):
        res = chip_smoke.phase_ingest(seconds=0.5, rate=2e5, chunk=8192)
        assert res["ok"], res["check"]

    def test_report_raises_on_failure(self, capsys):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.report({"phase": "x", "size": "1", "compile_s": 0.0,
                               "run_s": 0.0, "check": "bad", "ok": False},
                              "card")
        assert "check=FAIL" in capsys.readouterr().out

    def test_wbfm_reference_matches_block_taps(self):
        """The float64 reference decimates with the block's own taps."""
        _, rcv = chip_smoke.wfm_graph()
        iq = chip_smoke.fm_iq(1, 2048, seed=3)[0]
        ref = chip_smoke.wbfm_reference(iq, rcv)
        assert ref.shape == (256,) and np.isfinite(ref).all()


def test_native_library_is_per_host(monkeypatch):
    """The native I/O library is named for this host, so a checkout copied
    to another machine compiles its own."""
    import platform

    from grtpu.io import native

    here = native.library_path()
    monkeypatch.setattr(platform, "node", lambda: "another-host")
    assert native.library_path() != here
    assert os.path.dirname(here).endswith(os.path.join("native", "build"))

