"""The whole-name check of loaded modules, and the runs that must print no
result: no card, and a directory holding only the manifest and the
benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.registry import PACKAGE_DIR
from portbench.run import forbidden_modules

ROOT = PACKAGE_DIR.parent


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("hm_retrieval_tpu", True),
    ("hm_retrieval_tpu.models.tower", True), ("chip_smoke", True),
    ("bench", True), ("benchmarks.hm", True),
    ("hm_retrieval_tpu_torch", False), ("hm_retrieval_tpu_torch.ops", False),
    ("jaxfoo", False), ("benchmark", False), ("portbench.run", False),
])
def test_whole_top_level_names(name, flagged):
    assert bool(forbidden_modules({name: None})) is flagged


def _run(cwd, *args, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_harness_module_and_the_port_load_without_jax():
    code = ("import sys, importlib\n"
            "from portbench import run, calibrate, system, compare, inputs\n"
            "from portbench import trace, window\n"
            "from portbench.kinds import retrieve_closed_loop, train_steps\n"
            "from portbench.reference import two_tower, roofline\n"
            "from portbench.registry import Registry\n"
            "r = Registry()\n"
            "[r.reader(m['name']) for m in r.manifest['per_layer']]\n"
            "import hm_retrieval_tpu_torch.serving, hm_retrieval_tpu_torch.indices\n"
            "import hm_retrieval_tpu_torch.models.train_path\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_prints_no_result():
    out = _run(ROOT, "portbench.run", "--workload", "hm_e128.train_b8192",
               "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__", "out"))
    out = _run(tmp_path, "portbench.run", "--workload",
               "hm_e128.retrieve_b1024", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
