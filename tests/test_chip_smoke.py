"""CPU tests of chip_smoke.py's helpers, of the device and cache rules
it shares with the tests and bench.py, and of its refusal to run
without a GPU or without the repository."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from htscodecs_tpu import _device

REPO = Path(__file__).resolve().parent.parent


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_gpu_device_refuses_cpu():
    import jax
    with pytest.raises(RuntimeError, match="no GPU"):
        _device.gpu_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        _device.gpu_device(jax.devices("cpu"))


def test_gpu_device_reports_platform_kind_count():
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert _device.gpu_device(devs) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_result_line_shape():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


@pytest.mark.parametrize("env,want", [
    ({}, _device.CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, _device.CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": "/x/jc"}, Path("/x/jc")),
])
def test_cache_dir_rule(env, want):
    assert _device.cache_dir(env) == want


def test_default_cache_dir_is_ignored_by_git():
    assert _device.CACHE_DIR.parent == REPO
    ignored = (REPO / ".gitignore").read_text().split()
    assert _device.CACHE_DIR.name + "/" in ignored


@pytest.mark.parametrize("gen,lo,hi", [
    (chip_smoke.novaseq, 4, 4), (chip_smoke.illumina, 28, 40),
    (chip_smoke.longread, 80, 89)])
def test_generators_shape_and_alphabet(gen, lo, hi):
    x = gen(3, 4096, np.random.default_rng(0))
    assert x.shape == (3, 4096) and x.dtype == np.uint8
    widths = [len(np.unique(r)) for r in x]
    assert lo <= min(widths) and max(widths) <= hi
    assert np.array_equal(x, gen(3, 4096, np.random.default_rng(0)))


def test_alone_exits_nonzero_without_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_exits_nonzero_without_gpu(capsys):
    import bench
    assert bench.main() != 0
    assert "metric" not in capsys.readouterr().out
