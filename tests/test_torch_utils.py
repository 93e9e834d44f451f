"""The port's utils: the runtime config (the cases of tests/test_config.py
against the port's classes), PhaseTimer, device_trace on the CPU, and the
compile-cache latch and opt-out (tests/test_compile_cache.py's policy)."""

import json
import os

import pytest

import aho_corasick_1975_tpu_torch as act
from aho_corasick_1975_tpu_torch.parallel.mesh import make_mesh
from aho_corasick_1975_tpu_torch.utils import compile_cache as cc
from aho_corasick_1975_tpu_torch.utils.config import (MachineConfig,
                                                      MeshConfig, ScanConfig)
from aho_corasick_1975_tpu_torch.utils.profiling import (PhaseTimer,
                                                         device_trace)


def test_config_builds_scanner_with_all_knobs():
    cfg = MachineConfig(
        incremental=False,
        scan=ScanConfig(n_streams=8, step_k=2, prefilter="auto",
                        engine="gather", device_encode=False, device="cpu"),
        mesh=MeshConfig(n_streams_per_device=4, prefilter="on"))
    m = cfg.build_machine()
    assert m.incremental is False
    for w in ("he", "she", "hers"):
        m.insert_keyword(w)
    sc = cfg.build_scanner(m)
    assert sc._prefilter == "auto" and sc._engine == "gather"
    assert sc._device_encode is False and sc.step_k == 2
    assert sc.device.type == "cpu"
    assert sc.count("ushers") == 3
    sh = cfg.build_sharded_scanner(m, mesh=make_mesh(devices=["cpu"] * 8))
    assert sh._prefilter == "on" and sh.n_dev == 8
    assert sh.count("ushers" * 100) == 300
    d = json.loads(cfg.to_json())
    assert d["scan"]["prefilter"] == "auto"
    assert d["mesh"]["prefilter"] == "on"
    assert d["scan"]["device"] == "cpu"


def test_config_defaults_round_trip():
    cfg = MachineConfig(scan=ScanConfig(device="cpu"))
    m = cfg.build_machine()
    m.insert_keyword("abc")
    assert cfg.build_scanner(m).count("abcabc") == 2
    assert act.MachineConfig is MachineConfig
    assert act.ScanConfig is ScanConfig and act.MeshConfig is MeshConfig


def test_phase_timer():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("scan"):
            pass
    with pytest.raises(RuntimeError):
        with t.phase("decode"):
            raise RuntimeError("recorded all the same")
    rep = t.report()
    assert list(rep) == ["decode", "scan"]
    assert rep["scan"]["calls"] == 3 and rep["decode"]["calls"] == 1
    assert rep["scan"]["seconds"] >= 0


def test_device_trace_writes_a_trace(tmp_path):
    m = act.Machine()
    m.insert_keyword("he")
    sc = m.scanner(device="cpu", n_streams=4)
    with device_trace(str(tmp_path / "trace")) as prof:
        assert sc.count("hehe" * 100) == 200
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert prof.key_averages()


def test_compile_cache_latch_and_opt_out(monkeypatch, tmp_path):
    for v, want in [("off", False), ("0", False), ("no", False),
                    ("FALSE", False), ("", True), ("on", True)]:
        monkeypatch.setenv("ACX_COMPILE_CACHE", v)
        assert cc._enabled() is want, v
    monkeypatch.setattr(cc, "_done", False)
    monkeypatch.setattr(cc, "_active", None)
    monkeypatch.setenv("ACX_COMPILE_CACHE", "off")
    assert cc.enable_compile_cache() is None
    monkeypatch.setenv("ACX_COMPILE_CACHE", "on")
    assert cc.enable_compile_cache() is None   # the latch holds
    monkeypatch.setattr(cc, "_done", False)
    from aho_corasick_1975_tpu_torch.ops.build import BUILD_DIR
    assert cc.enable_compile_cache() == BUILD_DIR
    assert cc.enable_compile_cache(path=str(tmp_path)) == BUILD_DIR
    monkeypatch.setattr(cc, "_done", False)
    assert cc.enable_compile_cache(path=str(tmp_path)) == str(tmp_path)
    monkeypatch.setattr(cc, "_done", False)
    assert cc.enable_compile_cache(enabled=False) is None
    # scanners construct under either setting
    m = act.Machine()
    m.insert_keyword("he")
    assert m.scanner(device="cpu", n_streams=4).count("hehe") == 2
