"""``examples/run_hm_torch.py`` against ``examples/run_hm.py``.

Tiny H&M-shaped CSVs (``chip_smoke.write_hm_csvs``: the file names and
columns ``run_hm.py`` reads, zero-padded article ids, missing ages and FN)
go through ``run_hm.py --platform cpu --stages etl,schema,shards`` in a
subprocess and through the port's CLI with the same flags: the sampled CSV
must equal pandas' byte for byte and every shard array the JAX run's, bit
for bit, streamed and in memory. Then, on the CPU, the port's stage-sliced
runs equal an ``all`` run, ``--resume`` logs the epochs override and goes on
from the checkpoint, the mesh flags build their CPU meshes,
``--export-savedmodel`` without tensorflow raises before any step, and the
entry point raises without a card.
"""

import importlib.util
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from hm_retrieval_tpu_torch.data.dataset import ShardDataset
from hm_retrieval_tpu_torch.runners import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
SPLITS = ("train", "test", "candidates")
FRONT = ["--stages", "etl,schema,shards", "--history", "4", "--sample",
         "0.7"]
STREAM = ["--etl-chunk-rows", "700", "--schema-stream-rows", "500",
          "--shard-stream-rows", "400"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs are tiny, and under parallel test
    workers torch's thread pool spends its time waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example():
    spec = importlib.util.spec_from_file_location(
        "run_hm_torch", ROOT / "examples" / "run_hm_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def args(data, work, *extra):
    return ["--data-dir", str(data), "--workdir", str(work), *extra]


@pytest.fixture(scope="module")
def hm_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hm_raw")
    chip_smoke.write_hm_csvs(d, n_transactions=3000, n_customers=300,
                             n_articles=200, seed=3)
    return d


@pytest.fixture(scope="module")
def jax_front(hm_csvs, tmp_path_factory):
    """``examples/run_hm.py --platform cpu`` with FRONT and STREAM, in a
    subprocess; returns its workdir."""
    work = tmp_path_factory.mktemp("jax_hm")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "run_hm.py"),
         *args(hm_csvs, work, *FRONT, *STREAM, "--platform", "cpu")],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return work


def assert_same_shards(a, b):
    for split in SPLITS:
        da, db = ShardDataset(str(a / "shards" / split)), ShardDataset(
            str(b / "shards" / split))
        assert da.manifest == db.manifest, split
        assert sorted(os.listdir(a / "shards" / split)) == sorted(
            os.listdir(b / "shards" / split))
        for pa, pb in zip(da.shard_paths, db.shard_paths):
            with np.load(pa) as za, np.load(pb) as zb:
                assert za.files == zb.files
                for key in za.files:
                    assert za[key].dtype == zb[key].dtype, (split, key)
                    np.testing.assert_array_equal(za[key], zb[key],
                                                  err_msg=f"{split}/{key}")


@pytest.mark.parametrize("stream", [True, False], ids=["streamed",
                                                       "in_memory"])
def test_front_stages_write_run_hms_shards(hm_csvs, jax_front, tmp_path,
                                           stream):
    work = tmp_path / "port"
    example().main(args(hm_csvs, work, *FRONT, *(STREAM if stream else ()),
                        "--device", "cpu"))
    assert ((work / "transactions_sampled.csv").read_bytes()
            == (jax_front / "transactions_sampled.csv").read_bytes())
    assert_same_shards(work, jax_front)
    assert (work / "processed" / "train.npz").exists()
    assert not (work / "processed" / "train.parquet").exists()


@pytest.mark.parametrize("frac", [0.0105, 0.5, 0.999, 1.0])
def test_the_sample_equals_pandas_byte_for_byte(hm_csvs, tmp_path, frac):
    """``round(frac * n)`` rows of ``RandomState(0).choice``, in draw
    order, written as ``to_csv(index=False)`` writes them; also over a CSV
    with missing values, zero-padded ids and long decimals."""
    odd = tmp_path / "odd.csv"
    odd.write_text(
        "t_dat,customer_id,article_id,price,sales_channel_id,flag\n"
        + "".join(
            f"2020-01-{1 + i % 28:02d},c{i % 7},{i * 37 % 1000:010d},"
            f"{'' if i % 11 == 0 else 0.1 * i + 1 / 3},{1 + i % 2},"
            f"{'true' if i % 3 else 'false'}\n"
            for i in range(1001)))
    module = example()
    for src in (hm_csvs / "transactions_train.csv", odd):
        dst = tmp_path / f"{src.stem}_sampled.csv"
        module.sample_transactions(str(src), str(dst), frac)
        want = pd.read_csv(src).sample(frac=frac, random_state=0).to_csv(
            index=False)
        assert dst.read_text() == want, src.name


@pytest.fixture(scope="module")
def sliced(hm_csvs, tmp_path_factory):
    """The front stages, then ``--stages model,baseline``, in one workdir:
    (workdir, results, baseline, the step count). The second call samples
    again, as ``run_hm.py`` does, so the baseline counts the sampled
    transactions (without ``--sample`` it counts the whole file)."""
    work = tmp_path_factory.mktemp("sliced")
    module = example()
    module.main(args(hm_csvs, work, *FRONT, "--device", "cpu"))
    results, baseline = module.main(args(
        hm_csvs, work, "--stages", "model,baseline", "--sample", "0.7",
        "--device", "cpu"))
    steps = CheckpointManager(str(work / "artifacts" / "checkpoints"),
                              device="cpu").latest_step()
    return work, results, baseline, steps


def test_sliced_runs_equal_an_all_run(hm_csvs, sliced, tmp_path, capsys):
    work, results, baseline, _ = sliced
    got = example().main(args(hm_csvs, tmp_path / "all", "--stages", "all",
                              "--history", "4", "--sample", "0.7",
                              "--device", "cpu"))
    assert got == (results, baseline)
    assert results["final"][100] > results["initial"][100]
    assert set(baseline) <= {10, 100, 1000}
    printed = capsys.readouterr().out
    assert "=== Results ===" in printed
    assert f"trained model recall:   {results['final']}" in printed
    assert f"popularity baseline:    {baseline}" in printed


def copy_of(work, tmp_path):
    dst = tmp_path / "work"
    shutil.copytree(work, dst)
    return dst


def test_resume_logs_the_override_and_goes_on(hm_csvs, sliced, tmp_path,
                                              caplog):
    work, results, _, steps = sliced
    work = copy_of(work, tmp_path)
    with caplog.at_level(logging.WARNING):
        got, baseline = example().main(args(
            hm_csvs, work, "--stages", "model", "--epochs", "2", "--resume",
            "--device", "cpu"))
    assert baseline is None
    assert "Overriding schema TrainingConfig.epochs: 1 -> 2" in caplog.text
    assert got["initial"] == results["final"]
    ckpt = CheckpointManager(str(work / "artifacts" / "checkpoints"),
                             device="cpu")
    assert ckpt.latest_step() == 3 * steps  # two epochs after one


@pytest.mark.parametrize("flags, shape", [
    (["--mesh-data", "2"], (2, 1)),
    (["--mesh-model", "2", "--sharded-features", "customer_id",
      "--distributed-index"], (1, 2)),
], ids=["data_2", "model_2_sharded"])
def test_mesh_flags_build_cpu_meshes(hm_csvs, sliced, tmp_path, monkeypatch,
                                     flags, shape):
    from hm_retrieval_tpu_torch import parallel

    built = []
    make_mesh = parallel.make_mesh

    def spy(data=None, model=1, devices=None):
        built.append((data, model, devices))
        return make_mesh(data, model, devices)

    monkeypatch.setattr(parallel, "make_mesh", spy)
    work = copy_of(sliced[0], tmp_path)
    shutil.rmtree(work / "artifacts")
    got, _ = example().main(args(hm_csvs, work, "--stages", "model",
                                 *flags, "--device", "cpu"))
    assert built == [(*shape, ["cpu"] * (shape[0] * shape[1]))]
    assert got["final"][100] > got["initial"][100]
    assert all(0.0 <= v <= 1.0 for r in got.values() for v in r.values())


def test_export_without_tensorflow_raises_before_any_step(hm_csvs, sliced,
                                                         tmp_path,
                                                         monkeypatch):
    work = copy_of(sliced[0], tmp_path)
    shutil.rmtree(work / "artifacts")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        example().main(args(hm_csvs, work, "--stages", "model,baseline",
                            "--export-savedmodel", "--device", "cpu"))
    assert not (work / "artifacts").exists()


def test_the_entry_point_raises_without_a_card(hm_csvs, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = example()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args(hm_csvs, tmp_path / "w", *FRONT))
    with pytest.raises(SystemExit):
        module.main(args(hm_csvs, tmp_path / "w", "--stages", "etl,train",
                         "--device", "cpu"))
    assert not (tmp_path / "w").exists()
    # the card's mesh takes the visible cards: none here
    from hm_retrieval_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(data=4, model=1)
