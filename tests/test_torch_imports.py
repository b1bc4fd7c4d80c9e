"""The port stands alone: no JAX and nothing of the JAX package in
hm_retrieval_tpu_torch, chip_smoke.py, bin_max_bench.py or
examples/run_synthetic_torch.py, nothing the card's machine lacks (pandas,
pyarrow) on its import path, tensorboardX only behind a guard, no silent
CPU fallback when the card is absent, and no plain fallback when the host
library cannot be built (its build reads only the port's csrc/). Serving records no autograd graph, though the towers'
parameters are trainable."""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hm_retrieval_tpu_torch
from hm_retrieval_tpu_torch.device import resolve_device
from hm_retrieval_tpu_torch.indices import load_index
from hm_retrieval_tpu_torch.indices.brute_force import BruteForceIndex
from hm_retrieval_tpu_torch.ops import _build
from hm_retrieval_tpu_torch.ops import bin_topk as bt
from hm_retrieval_tpu_torch.ops import partial_reduce as pr
from hm_retrieval_tpu_torch.ops import quantized_topk as qt
from hm_retrieval_tpu_torch.ops.exact_topk import exact_topk_scores
from hm_retrieval_tpu_torch.serving import RetrievalService
from tests.test_torch_runners import jax_stages  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "hm_retrieval_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "hm_retrieval_tpu", "pandas")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bin_max_bench.py",
        ROOT / "examples" / "run_synthetic_torch.py",
        ROOT / "examples" / "run_hm_torch.py",
    ]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_forbidden_import(path):
    assert path.exists()
    bad = [
        m
        for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    code = (
        "import sys\n"
        + "".join(
            f"import {m.removesuffix('.__init__')}\n" for m in mods
        )
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN + ("pyarrow", "tensorflow"))
        + ")\nprint(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_spawned_ranks_import_only_the_port():
    """The module whose rank function ``tests/test_torch_multiprocess.py``
    spawns, and ``chip_smoke.py`` whose phase 14 spawns its ranks from
    itself, leave JAX and the JAX package out of a fresh interpreter's
    ``sys.modules`` (each spawned rank also reports its own)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_multiprocess, chip_smoke\n"
        "from hm_retrieval_tpu_torch.parallel import initialize_multihost\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + ")\nprint(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_initialize_multihost_alone_stays_single_process(monkeypatch, caplog):
    """No arguments and no torchrun environment: a single-process run,
    logged, and no group formed."""
    import logging

    from hm_retrieval_tpu_torch.parallel.mesh import (
        TORCHRUN_ENV,
        initialize_multihost,
    )

    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with caplog.at_level(logging.INFO,
                         logger="hm_retrieval_tpu_torch.parallel.mesh"):
        assert initialize_multihost() is None
    assert "single-process run" in caplog.text
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize(
    "module", ["dataset", "device_feed", "shard_writer", "__init__"]
)
def test_the_data_copies_import_only_the_port(module):
    """The reader and the manifest name are the port's own copies."""
    roots = {
        m.split(".")[0]
        for m in _imported_modules(PKG / "data" / f"{module}.py")
    }
    assert roots <= {
        "__future__", "concurrent", "glob", "json", "logging", "os",
        "queue", "threading", "typing", "numpy", "torch",
        "hm_retrieval_tpu_torch",
    }, roots


# the modules of the modelling runner and what they may import
RUNNER_MODULES = {
    "metrics/index_recall.py": {"numpy", "torch"},
    "metrics/__init__.py": set(),
    "ops/topk.py": {"torch"},
    "indices/builder.py": {"itertools", "numpy", "torch"},
    "indices/distributed.py": {"json", "os", "numpy", "torch"},
    "indices/static_index.py": {"json", "os", "numpy", "torch"},
    "etl/transformations.py": {"csv", "dataclasses", "io", "itertools",
                               "json", "operator", "os", "re", "shutil",
                               "zipfile", "numpy", "pyarrow"},
    "etl/runner.py": {"csv", "os", "shutil", "numpy"},
    "etl/__init__.py": set(),
    "data/runner.py": {"numpy"},
    "data/shard_writer.py": {"json", "os", "numpy"},
    "schema/features.py": {"dataclasses", "enum", "itertools", "numpy"},
    "schema/schema.py": {"dataclasses", "json", "os", "numpy"},
    "utils/synthetic.py": {"itertools", "os", "numpy"},
    "parallel/mesh.py": {"numpy", "os", "torch"},
    "parallel/distributed_topk.py": {"numpy", "torch"},
    "parallel/collectives.py": {"torch"},
    "parallel/global_negatives.py": {"numpy", "torch"},
    "parallel/data_parallel.py": {"torch"},
    "parallel/sparse_data_parallel.py": {"torch"},
    "parallel/sharded_embedding.py": {"numpy", "torch"},
    "parallel/sharded_training.py": set(),
    "parallel/sharded_sparse_training.py": {"torch"},
    "parallel/__init__.py": set(),
    "runners/baseline.py": set(),
    "runners/checkpoint.py": {"concurrent", "json", "os", "shutil", "uuid"},
    "runners/modelling.py": {"dataclasses", "itertools", "time", "numpy",
                             "torch"},
    "runners/__init__.py": set(),
    "utils/settings.py": {"dataclasses", "json", "os"},
    "utils/summary.py": {"os", "time", "numpy", "tensorboardX"},
    "utils/profiling.py": {"os", "torch"},
    "utils/__init__.py": set(),
    # the host surface: TFRecord bridge, NaN checks, SavedModel export
    # (tensorflow only inside export_index_savedmodel)
    "data/tfrecord_compat.py": {"glob", "os", "struct", "numpy"},
    "utils/debugging.py": {"torch"},
    "serving/savedmodel_export.py": {"importlib", "numpy", "tensorflow"},
    "serving/__init__.py": set(),
}


@pytest.mark.parametrize("module", sorted(RUNNER_MODULES))
def test_the_runner_modules_import_only_the_port(module):
    """The runners' modules (the ETL, schema and shard stages' too, and the
    host surface's) import the port, the standard library's listed modules,
    numpy and torch; tensorboardX only inside a guard (``utils/summary.py``
    logs when it is absent), pyarrow only inside the functions that read or
    write ``.parquet``, tensorflow only inside the SavedModel export."""
    roots = {
        m.split(".")[0] for m in _imported_modules(PKG / module)
    } - {"__future__", "logging", "typing", "hm_retrieval_tpu_torch"}
    assert roots <= RUNNER_MODULES[module], roots


def test_the_baseline_runs_without_pandas(jax_stages, tmp_path):  # noqa: F811
    """Where ``import pandas`` fails, as on the card's machine, the port's
    transformations, static index and baseline runner import, and the
    baseline runs on the CPU over a CSV of the tiny pipeline."""
    settings_json = os.path.join(
        os.path.dirname(jax_stages.schema_dirpath), "settings.json")
    code = (
        "import dataclasses, sys\n"
        "sys.modules['pandas'] = None\n"
        "import hm_retrieval_tpu_torch.etl.transformations\n"
        "import hm_retrieval_tpu_torch.indices.static_index\n"
        "from hm_retrieval_tpu_torch.runners.baseline import (\n"
        "    baseline_modelling_runner)\n"
        "from hm_retrieval_tpu_torch.utils import Settings\n"
        f"s = Settings.from_json({settings_json!r})\n"
        "s = dataclasses.replace(s, baseline_index_dirpath="
        f"{str(tmp_path / 'baseline')!r})\n"
        "res = baseline_modelling_runner(s, device='cpu')\n"
        "print(sorted(res), 'pandas' in sys.modules and "
        "sys.modules['pandas'] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[10, 50] False"
    assert (tmp_path / "baseline" / "identifiers.npy").exists()


def test_the_mesh_defaults_to_the_cards(no_card):
    from hm_retrieval_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"])
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.first_device == torch.device("cpu")


def test_the_writer_survives_without_tensorboardx():
    code = (
        "import sys; sys.modules['tensorboardX'] = None\n"
        "from hm_retrieval_tpu_torch.utils import summary\n"
        "w = summary.MetricWriter('logs-never-written')\n"
        "w.add_scalar('a', 1.0, 0); w.close()\n"
        "print(summary._HAVE_TB, w._writer)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(ROOT), env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "None"]
    assert not (ROOT / "logs-never-written").exists()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(no_card):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def _tiny_index_dir(tmp_path):
    rng = np.random.default_rng(0)
    idx = BruteForceIndex(
        3, np.arange(1, 51), rng.normal(size=(50, 4)), device="cpu"
    )
    idx.save(str(tmp_path / "index"))
    return str(tmp_path / "index")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    index_dir = _tiny_index_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalService.load("schema", "model", index_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_index(index_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BruteForceIndex(3, np.arange(5), np.zeros((5, 4)))
    assert load_index(index_dir, device="cpu").k == 3


def test_runner_entry_points_raise_without_a_card(no_card, tmp_path):
    """The modelling runner's entry points resolve ``device=None`` to the
    card before they read anything, and run on the CPU only when asked."""
    from hm_retrieval_tpu_torch.runners import (
        CheckpointManager, build_index, evaluation_runner, modelling_runner,
    )
    from hm_retrieval_tpu_torch.utils import Settings

    settings = Settings(schema_dirpath=str(tmp_path / "missing"))
    for fn in (modelling_runner, evaluation_runner):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(settings)
        with pytest.raises(FileNotFoundError):  # got past the device
            fn(settings, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index(None, None, 10, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointManager(str(tmp_path / "ckpt"))
    assert CheckpointManager(str(tmp_path / "ckpt"), device="cpu").device == (
        torch.device("cpu"))


def test_cuda_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel or raises; here
    the 'meta' device stands in for a device the wrappers cannot run."""
    q = torch.zeros(4, 16, device="meta")
    c = torch.zeros(1024, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bt.exact_topk(q, c, 10, L=256)
    scores = torch.zeros(4, 4096, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pr.partial_reduce(scores, 1024, 2)
    for split in (1, 2, 4):  # a split the kernel takes: still no plain path
        with pytest.raises(ValueError, match="unsupported device"):
            pr.partial_reduce(scores, 1024, 2, split=split)
    with pytest.raises(ValueError, match="unsupported device"):
        exact_topk_scores(scores, 32)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("bin_max2")
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build_all()
    assert list((tmp_path / "build").glob("*.so")) == []


def test_the_host_library_imports_only_the_port():
    """``native_ext.py`` imports neither JAX nor the JAX package, and a fresh
    interpreter that encodes, frames and scans through it has neither in
    ``sys.modules``."""
    path = PKG / "native_ext.py"
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "hm_retrieval_tpu")]
    code = (
        "import sys\n"
        "from hm_retrieval_tpu_torch import native_ext as ne\n"
        "ne.NativeSeqVocab(['a']).encode_tokens(['a'])\n"
        "ne.NativeVocab(['a']).encode(['a'])\n"
        "ne.tfrecord_scan(ne.tfrecord_frame(b'ab', [0, 1, 2]))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        + repr(FORBIDDEN) + ")\nprint(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_host_build_reads_only_the_ports_csrc(monkeypatch, tmp_path):
    """``build_host`` hands ``g++`` only ``hm_retrieval_tpu_torch/csrc/*.cpp``
    (never ``native/``, never a ``.cu``), writes only into the build
    directory, and ``nvcc``'s sources stay the ``.cu`` files."""
    assert _build.CSRC_DIR == PKG / "csrc"
    assert _build.host_sources() == ["seqencode", "shardio"]
    assert _build.sources() == ["bin_max2", "partial_reduce"]
    commands = []

    class Recorder:
        def __init__(self, cmd, **kwargs):
            commands.append(cmd)
            self.returncode = 1

        def communicate(self):
            return "recorded, not built", None

    monkeypatch.setattr(_build.shutil, "which", lambda name: "/bin/g++")
    monkeypatch.setattr(_build.subprocess, "Popen", Recorder)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="recorded, not built"):
        _build.build_host()
    assert len(commands) == 2
    for cmd in commands:
        assert cmd[0] == "/bin/g++"
        assert cmd[1:6] == ["-O3", "-std=c++17", "-fPIC", "-pthread",
                            "-shared"]
        sources = [a for a in cmd if a.endswith((".cpp", ".cu", ".cc"))]
        assert len(sources) == 1
        assert Path(sources[0]).parent == PKG / "csrc"
        assert sources[0].endswith(".cpp")
        out = Path(cmd[cmd.index("-o") + 1])
        assert out.parent == tmp_path / "build"
    assert not [c for c in commands if any("native" + os.sep in a
                                           for a in c)]


def test_missing_gxx_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """Without ``g++`` (and nothing built), every encoder and every TFRecord
    function raises ``RuntimeError``: none returns the plain result."""
    from hm_retrieval_tpu_torch import native_ext
    from hm_retrieval_tpu_torch.data import tfrecord_compat as tfc
    from hm_retrieval_tpu_torch.schema.features import Feature

    path = tmp_path / "t.tfrecord"
    path.write_bytes(tfc._frame([b"ab", b"c"]))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    cat = Feature("c", "categorical", "query", embedding_size=4,
                  vocab=["a", "b"])
    seq = Feature("s", "sequence", "query", embedding_size=4,
                  vocab=["a", "b"], max_len=2)
    calls = [
        lambda: cat.encode(np.array(["a", "b"])),
        lambda: cat.encode(np.array(["a", None], dtype=object)),
        lambda: seq.encode_sequence([["a"], ["b", "a"]]),
        lambda: list(tfc.iter_tfrecords(str(path))),
        lambda: tfc.write_tfrecords(str(tmp_path / "w.tfrecord"), [b"x"]),
        lambda: tfc.masked_crc32c(b"x"),
        lambda: native_ext.gather_rows(np.arange(3), np.array([0])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
    assert not (tmp_path / "build").exists()
    assert not (tmp_path / "w.tfrecord").exists()
    # the plain versions need no library
    assert cat.encode_plain(np.array(["b"])).tolist() == [2]


def test_failed_host_build_raises_with_the_compilers_output(monkeypatch,
                                                            tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no compiler here"):
        _build.load_host("shardio")
    assert list((tmp_path / "build").iterdir()) == []


def test_sources_and_launch_counters():
    assert _build.sources() == ["bin_max2", "partial_reduce"]
    assert set(bt.LAUNCHES) == {
        "bin_max2_first_round",
        "bin_max2_round",
        "bin_max_round",
    }
    assert set(qt.LAUNCHES) == {
        "bin_max2_scaled_single_pass",
        "bin_max2_scaled_fold_pass",
        "bin_max2_raw_fold_pass",
        "bin_max2_scaled_first_round",
        "bin_max2_scaled_round",
    }
    assert set(pr.LAUNCHES) == {"partial_reduce"}
    bt.LAUNCHES["bin_max2_round"] += 3
    qt.LAUNCHES["bin_max2_raw_fold_pass"] += 2
    pr.LAUNCHES["partial_reduce"] += 1
    bt.reset_launches()
    qt.reset_launches()
    pr.reset_launches()
    assert set(bt.LAUNCHES.values()) == {0}
    assert set(qt.LAUNCHES.values()) == {0}
    assert set(pr.LAUNCHES.values()) == {0}
    # the plain CPU path does not count as a kernel launch
    bt.exact_topk(torch.randn(3, 16), torch.randn(700, 16), 5, L=256)
    bt.exact_topk(torch.randn(3, 16), torch.randn(700, 16), 5, L=256,
                  keep_per_bin=1)
    bt.exact_topk(torch.randn(256, 16), torch.randn(700, 16), 5, L=256,
                  lockstep=True)
    codes = torch.randint(-127, 128, (1024, 16), dtype=torch.int8)
    qt.quantized_topk(torch.randn(3, 16), codes, torch.rand(1024), 5, L=256,
                      max_rounds=1)
    qt.quantized_topk(torch.randn(3, 16), codes, torch.rand(1024), 5, L=256)
    qt.quantized_topk_global(torch.randn(3, 16), codes, 0.1, 5, L=256)
    exact_topk_scores(torch.randn(3, 4096), 32)
    assert set(bt.LAUNCHES.values()) == {0}
    assert set(qt.LAUNCHES.values()) == {0}
    assert set(pr.LAUNCHES.values()) == {0}
    assert hm_retrieval_tpu_torch.__version__


def _launchers():
    """{source: {C launcher: its parameter types}} of csrc/*.cu."""
    out = {}
    for name in _build.sources():
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        out[name] = {
            fn: [" ".join(p.split()[:-1]) for p in params.split(",")]
            for fn, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text)
        }
    return out


def test_each_wrapper_binds_a_launcher_of_its_source():
    """Every wrapper loads its C launcher from its source: bin_max2.cu,
    whose template holds all eight bin-max kernels (the raw pass of the
    global-scale index included), or partial_reduce.cu, with one ctypes
    type per parameter: a pointer (or the stream) as c_void_p, an int as
    c_int."""
    launchers = _launchers()
    assert set(launchers) == {"bin_max2", "partial_reduce"}
    wrappers = {"bin_max2": {**bt._ARGTYPES, **qt._ARGTYPES},
                "partial_reduce": pr._ARGTYPES}
    for source, argtypes in wrappers.items():
        assert set(launchers[source]) == set(argtypes)
        for fn, params in launchers[source].items():
            want = [ctypes.c_int if p == "int" else ctypes.c_void_p
                    for p in params]
            assert argtypes[fn] == want, fn
    # the raw pass is the template's raw kind, launched with no scales
    text = (_build.CSRC_DIR / "bin_max2.cu").read_text()
    raw = text[text.index('extern "C" int bin_max2_raw_fold_pass'):]
    raw = raw[:raw.index("}")]
    assert "Catalog::kRaw" in raw and "scales" not in raw


def test_serving_records_no_autograd_graph(tmp_path):
    from hm_retrieval_tpu_torch.indices.builder import collect_catalog_device
    from hm_retrieval_tpu_torch.indices.quantized import QuantizedIndex
    from hm_retrieval_tpu_torch.models import TwoTowerModel
    from hm_retrieval_tpu_torch.schema import (
        Feature, ModelConfig, Schema, TrainingConfig,
    )

    vocab = np.array([f"x{i}" for i in range(30)])
    features = [
        Feature("customer_id", "categorical", "query", embedding_size=8,
                vocab=vocab),
        Feature("article_id", "categorical", "candidate", embedding_size=8,
                vocab=vocab),
    ]
    schema = Schema(features, ModelConfig(8, ks=[5]), TrainingConfig())
    model = TwoTowerModel.create_from_schema(schema, device="cpu")
    model.init_params(0)
    assert all(p.requires_grad for p in model.parameters())

    def embed(batch):  # a caller that forgets no_grad
        return model.candidate_forward(
            {k: torch.from_numpy(v) for k, v in batch.items()})

    ids, emb = collect_catalog_device(
        "article_id", embed,
        [{"article_id": np.arange(1, 31, dtype=np.int32)}], 30)
    assert not emb.requires_grad
    with_grad = embed({"article_id": np.arange(1, 31, dtype=np.int32)})
    assert with_grad.requires_grad
    exact = BruteForceIndex(5, ids, with_grad, device="cpu")
    quant = QuantizedIndex(5, ids, with_grad, device="cpu")
    for index in (exact, quant):
        scores, _ = index.topk_from_embeddings(with_grad[:3])
        assert not scores.requires_grad
    assert not exact.embeddings.requires_grad
    assert not quant.embeddings.requires_grad

    svc = RetrievalService(schema, model.query_tower, exact, device="cpu")
    q = svc.embed(svc.encode_query({"customer_id": ["x1", "x7", "nope"]}))
    assert not q.requires_grad and q.grad_fn is None
    assert len(svc.retrieve({"customer_id": ["x1"]})[0]) == 5
