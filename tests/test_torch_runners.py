"""The port's modelling stage on the tiny pipeline, from the port's own stages.

A module fixture runs the port's ETL, schema and shard stages on the data
of ``tests/test_runners.py`` (6,000 synthetic transactions, 300 customers,
120 articles, seed 1), another the JAX package's on the same CSVs; the
port's shards must equal the JAX stages' bit for bit. The port's
``modelling_runner`` then runs on the port's shards on the CPU. Recall must
rise as the JAX runner's does; the
port's exported towers, loaded into the JAX model, must give the port's
final recall through the JAX ``build_index`` + ``evaluate``; the eval-only
stage must reproduce it exactly; ``resume`` must continue the step count;
and the options the port does not have must raise before any step.
"""

import dataclasses
import importlib.util
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.data.dataset import ShardDataset as JaxShardDataset
from hm_retrieval_tpu.models import TwoTowerModel as JaxTwoTowerModel
from hm_retrieval_tpu.runners import (
    build_index as jax_build_index,
    build_schema_runner,
    etl_runner,
    evaluate as jax_evaluate,
    shard_writer_runner,
)
from hm_retrieval_tpu.schema import (
    Feature,
    FeatureFamily,
    FeatureKind,
    ModelConfig,
    Schema as JaxSchema,
    TrainingConfig,
)
from hm_retrieval_tpu.utils.pytree_io import load_pytree_npz
from hm_retrieval_tpu.utils.settings import Settings as JaxSettings
from hm_retrieval_tpu.utils.synthetic import generate_hm_like_csvs

from hm_retrieval_tpu_torch.parallel import Mesh, make_mesh
from hm_retrieval_tpu_torch.runners import (
    CheckpointManager,
    build_schema_runner as port_build_schema_runner,
    etl_runner as port_etl_runner,
    evaluation_runner,
    modelling_runner,
    shard_writer_runner as port_shard_writer_runner,
)
from hm_retrieval_tpu_torch.schema.schema import Schema as PortSchema
from hm_retrieval_tpu_torch.utils.settings import Settings

KS = [10, 50]


@pytest.fixture(scope="module")
def jax_stages(tmp_path_factory):
    """The JAX package's ETL, schema and shard stages on the tiny data;
    returns the port's ``Settings`` read from their ``settings.json``."""
    return run_jax_stages(str(tmp_path_factory.mktemp("torch_pipeline")))


def stage_inputs(d: str, split_ext: str):
    """The tiny pipeline's CSVs, its settings' fields (splits ending in
    ``split_ext``) and its schema's arguments."""
    raw = generate_hm_like_csvs(
        os.path.join(d, "raw"),
        n_transactions=6000,
        n_customers=300,
        n_articles=120,
        seed=1,
    )
    fields = dict(
        transactions_filepath=raw["transactions"],
        articles_filepath=raw["articles"],
        customers_filepath=raw["customers"],
        train_start_date=raw["train_start"],
        train_end_date=raw["train_end"],
        test_start_date=raw["test_start"],
        test_end_date=raw["test_end"],
        train_data_filepath=f"{d}/processed/train.{split_ext}",
        test_data_filepath=f"{d}/processed/test.{split_ext}",
        schema_dirpath=f"{d}/schema",
        train_shards_dirpath=f"{d}/shards/train",
        test_shards_dirpath=f"{d}/shards/test",
        candidate_shards_dirpath=f"{d}/shards/candidates",
        model_dirpath=f"{d}/artifacts/model",
        index_dirpath=f"{d}/artifacts/index",
        checkpoint_dirpath=f"{d}/artifacts/ckpt",
        tensorboard_logs_dir=None,
        profile_steps=None,
        max_shard_rows=200,
    )
    schema = dict(
        features=[
            Feature("customer_id", FeatureKind.CATEGORICAL,
                    FeatureFamily.QUERY, embedding_size=16).to_dict(),
            Feature("article_id", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=16).to_dict(),
            Feature("product_type_name", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=4).to_dict(),
        ],
        model_config=ModelConfig(joint_embedding_size=16, ks=KS).to_dict(),
        training_config=TrainingConfig(
            train_batch_size=128,
            test_batch_size=256,
            candidate_batch_size=64,
            epochs=2,
            shuffle_buffer_size=4096,
            optimizer_kwargs={"learning_rate": 0.05},
        ).to_dict(),
    )
    return fields, schema


def _schema(package, args):
    """``Schema`` of ``package`` from ``stage_inputs``' arguments."""
    mod = package
    return mod.Schema(
        features=[mod.Feature.from_dict(f) for f in args["features"]],
        model_config=mod.ModelConfig.from_dict(args["model_config"]),
        training_config=mod.TrainingConfig.from_dict(
            args["training_config"]),
        candidate_id_col="article_id",
    )


def run_jax_stages(d: str) -> Settings:
    """``jax_stages``' work in directory ``d``."""
    import hm_retrieval_tpu.schema as jax_schema_pkg

    fields, args = stage_inputs(d, "parquet")
    jax_settings = JaxSettings(**fields)
    schema = _schema(jax_schema_pkg, args)
    etl_runner(jax_settings)
    build_schema_runner(jax_settings, schema)
    shard_writer_runner(jax_settings)
    # one settings.json drives either package
    jax_settings.to_json(f"{d}/settings.json")
    return Settings.from_json(f"{d}/settings.json")


def run_port_stages(d: str) -> Settings:
    """The port's ETL, schema and shard stages on the tiny data, with
    ``.npz`` splits, in directory ``d``."""
    import hm_retrieval_tpu_torch.schema as port_schema_pkg

    fields, args = stage_inputs(d, "npz")
    settings = Settings(**fields)
    port_etl_runner(settings)
    port_build_schema_runner(settings, _schema(port_schema_pkg, args))
    port_shard_writer_runner(settings)
    settings.to_json(f"{d}/settings.json")
    return settings


@pytest.fixture(scope="module")
def port_stages(tmp_path_factory):
    return run_port_stages(str(tmp_path_factory.mktemp("port_pipeline")))


@pytest.fixture(scope="module")
def pipeline(port_stages):
    """The port's first three stages, then its modelling stage on the
    CPU."""
    return port_stages, modelling_runner(port_stages, device="cpu")


def test_port_stages_write_the_jax_stages_shards(port_stages, jax_stages):
    """Every shard file, npz array and manifest of the port's stages equals
    the JAX stages' on the same CSVs; the schemas' vocabs and logQ too."""
    from tests.test_torch_shards import assert_same_shards
    from tests.test_torch_etl import assert_same_schema

    assert_same_shards(port_stages, jax_stages)
    assert_same_schema(port_stages.schema_dirpath, jax_stages.schema_dirpath)
    assert PortSchema.load(port_stages.schema_dirpath).logq is not None


def _example():
    spec = importlib.util.spec_from_file_location(
        "run_synthetic_torch",
        os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                     "run_synthetic_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("history", [False, True],
                         ids=["no_history", "history"])
def test_the_example_runs_the_five_stages_on_the_cpu(tmp_path, history):
    """``examples/run_synthetic_torch.py --device cpu`` at a tiny size: the
    five stages through the port, recall rising, the baseline beside it."""
    argv = ["--workdir", str(tmp_path / "w"), "--device", "cpu",
            "--transactions", "4000", "--customers", "150",
            "--articles", "200", "--epochs", "2", "--batch-size", "128"]
    results, baseline = _example().main(
        argv + (["--with-history"] if history else []))
    assert results["final"][100] > results["initial"][100]
    assert set(baseline) == {10, 100}
    assert (tmp_path / "w" / "processed" / "train.npz").exists()


def test_the_example_raises_before_any_stage(tmp_path, monkeypatch):
    """Without ``--device`` and no card it raises, and
    ``--export-savedmodel`` where tensorflow cannot be imported raises
    ``ImportError`` naming it, each before anything is written."""
    example = _example()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main(["--workdir", str(tmp_path / "w")])
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        example.main(["--workdir", str(tmp_path / "w"), "--device", "cpu",
                      "--export-savedmodel"])
    assert not (tmp_path / "w").exists()


def _steps_per_epoch(settings):
    ds = JaxShardDataset(settings.train_shards_dirpath)
    return ds.num_rows // 128


def test_training_improves_recall(pipeline):
    _, results = pipeline
    assert results["final"][50] > results["initial"][50], results
    # random recall@10 over 120 articles ~ 0.083 (test_runners.py's bar)
    assert results["final"][10] > 0.15, results
    for res in results.values():
        assert set(res) == set(KS)
        assert all(0.0 <= v <= 1.0 for v in res.values())


def test_artifacts_exist(pipeline):
    settings, _ = pipeline
    for p in [
        f"{settings.model_dirpath}/two_tower/params.npz",
        f"{settings.model_dirpath}/query_tower/params.npz",
        f"{settings.model_dirpath}/candidate_tower/params.npz",
        f"{settings.index_dirpath}/index.npz",
        f"{settings.index_dirpath}/meta.json",
    ]:
        assert os.path.exists(p), p
    ckpt = CheckpointManager(settings.checkpoint_dirpath, device="cpu")
    assert ckpt.latest_step() == 2 * _steps_per_epoch(settings)
    assert len(ckpt.all_steps()) == 2  # one an epoch


def test_exported_towers_give_final_recall_in_jax(pipeline):
    """The port's exported towers in the JAX model, through the JAX
    ``build_index`` + ``evaluate`` (index "full" on both sides at 120
    articles): the towers sum in another order, so the recall counts may
    differ only where a true article's score ties the K-th within float
    rounding; this data shows no such tie, and the counts are equal."""
    settings, results = pipeline
    schema = JaxSchema.load(settings.schema_dirpath)
    tc, mc = schema.training_config, schema.model_config
    model = JaxTwoTowerModel.create_from_schema(schema)
    params = jax.tree.map(
        jnp.asarray,
        load_pytree_npz(f"{settings.model_dirpath}/two_tower/params.npz"),
    )
    cand_ds = JaxShardDataset(settings.candidate_shards_dirpath)
    index = jax_build_index(
        model, params, cand_ds, tc.candidate_batch_size,
        min(max(mc.ks), cand_ds.num_rows),
    )
    assert index.method == "full"
    got = jax_evaluate(
        model, params, index,
        JaxShardDataset(settings.test_shards_dirpath),
        tc.test_batch_size, mc.ks,
    )
    assert got == results["final"]


def test_evaluation_runner_equals_final(pipeline, tmp_path):
    settings, results = pipeline
    settings = dataclasses.replace(settings,
                                   index_dirpath=str(tmp_path / "index"))
    assert evaluation_runner(settings, device="cpu") == results["final"]
    assert os.path.exists(tmp_path / "index" / "index.npz")


def test_resume_continues_the_step_count(pipeline, tmp_path):
    """The resumed run starts from the checkpoint: its first evaluation is
    the first run's final one, and its step count goes on from there."""
    settings, results = pipeline
    shutil.copytree(settings.checkpoint_dirpath, tmp_path / "ckpt")
    settings = dataclasses.replace(
        settings,
        checkpoint_dirpath=str(tmp_path / "ckpt"),
        model_dirpath=str(tmp_path / "model"),
        index_dirpath=str(tmp_path / "index"),
    )
    before = CheckpointManager(settings.checkpoint_dirpath,
                               device="cpu").latest_step()
    res = modelling_runner(settings, device="cpu", resume=True,
                           training_overrides={"epochs": 1})
    after = CheckpointManager(settings.checkpoint_dirpath,
                              device="cpu").latest_step()
    assert after == before + _steps_per_epoch(settings)
    assert res["initial"] == results["final"]


def test_unknown_override_raises(pipeline):
    settings, _ = pipeline
    with pytest.raises(ValueError, match="unknown TrainingConfig field"):
        modelling_runner(settings, device="cpu",
                         training_overrides={"epochz": 1})


@pytest.mark.parametrize("option", ["savedmodel", "mesh", "distributed"])
def test_unported_options_raise_before_any_step(pipeline, tmp_path, monkeypatch,
                                                option):
    """Training over a mesh of several distinct devices, in one process or
    in a rank of a group, is ported (ROADMAP.md item 6.4, and 6.4 over
    ranks): no ``NotImplementedError``, but a grid
    naming ``cuda:0`` where there is no CUDA raises ``RuntimeError`` naming
    CUDA before any step; a sharded index without a mesh, and inside a process group of 2 ranks a
    mesh built for one process, raise ``ValueError``, as in the JAX package;
    the SavedModel export validates before any step (an unexportable schema
    raises ``ValueError``, a machine without TensorFlow ``ImportError``),
    then exports after the final evaluation. Each raise before any step.
    (The runner over a process group is ported:
    ``tests/test_torch_multiprocess.py``; the export against JAX's:
    ``tests/test_torch_savedmodel.py``.)"""
    from hm_retrieval_tpu_torch.runners import modelling

    settings, _ = pipeline
    settings = dataclasses.replace(
        settings, checkpoint_dirpath=str(tmp_path / "ckpt"),
        savedmodel_dirpath=(str(tmp_path / "sm") if option == "savedmodel"
                            else None))

    def no_trainer(*args, **kwargs):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(modelling, "make_single_device_trainer", no_trainer)
    monkeypatch.setattr(modelling, "make_mesh_trainer", no_trainer)
    if option == "distributed":
        with pytest.raises(ValueError, match="requires a mesh"):
            modelling_runner(settings, device="cpu", distributed_index=True)
    elif option == "savedmodel":
        from hm_retrieval_tpu_torch.serving import savedmodel_export

        with monkeypatch.context() as m:
            m.setitem(sys.modules, "tensorflow", None)
            with pytest.raises(ImportError, match="tensorflow"):
                modelling_runner(settings, device="cpu")
        with monkeypatch.context() as m:
            def unbuilt(schema):
                raise ValueError("SavedModel export: no vocab")

            m.setattr(savedmodel_export, "validate_exportable_schema",
                      unbuilt)
            m.setattr(modelling, "validate_exportable_schema", unbuilt)
            with pytest.raises(ValueError, match="SavedModel export"):
                modelling_runner(settings, device="cpu")
        assert not (tmp_path / "ckpt").exists()
        monkeypatch.undo()  # the trainers back: train, evaluate, export
        pytest.importorskip("tensorflow")
        modelling_runner(settings, device="cpu",
                         training_overrides={"epochs": 1})
        assert (tmp_path / "sm" / "saved_model.pb").exists()
        return
    else:
        grid = np.empty((2, 1), dtype=object)
        grid[0, 0], grid[1, 0] = torch.device("cpu"), torch.device("cuda", 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            modelling_runner(settings, device="cpu", mesh=Mesh(grid))
        one_device = make_mesh(2, 1, devices=["cpu"] * 2)
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        with pytest.raises(ValueError, match="spans 1 process"):
            modelling_runner(settings, device="cpu", mesh=one_device)
        with pytest.raises(ValueError, match="requires a mesh"):
            modelling_runner(settings, device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_the_runner_raises_without_a_card(pipeline, monkeypatch):
    settings, _ = pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (modelling_runner, evaluation_runner):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(settings)


# --- training over a one-process mesh ------------------------------------------
MESH_LAYOUTS = {
    # (data, model), distributed_index, sharded_embedding_features
    "dp_8x1": ((8, 1), False, []),
    "dp_2x4_distributed_index": ((2, 4), True, []),
    "row_sharded_2x4": ((2, 4), False, ["customer_id", "article_id"]),
}


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("layout", sorted(MESH_LAYOUTS))
def test_modelling_runner_over_a_mesh(pipeline, tmp_path, layout, sparse):
    """``modelling_runner(mesh=...)`` on the tiny pipeline's shards, on
    ``make_mesh(..., devices=["cpu"] * 8)``: data-parallel at (8, 1),
    data-parallel with the catalog sharded over a (2, 4) mesh, and the
    customer and article tables row-sharded over a (2, 4) mesh; the sparse
    step (the schema's default) and the dense one
    (``use_sparse_embedding_optimizer`` off, in a copy of the schema that
    ``evaluation_runner`` reads too). Recall rises, ends within 0.15 of the
    single-device run's (the JAX tests' bound, tests/test_runners.py), the
    export keeps the unsharded shapes, and ``evaluation_runner`` over the
    mesh restores the checkpoint and equals ``final``."""
    settings, single = pipeline
    shape, distributed, sharded = MESH_LAYOUTS[layout]
    schema = PortSchema.load(settings.schema_dirpath)
    schema.training_config = dataclasses.replace(
        schema.training_config, sharded_embedding_features=sharded,
        use_sparse_embedding_optimizer=sparse)
    schema.save(str(tmp_path / "schema"))
    settings = dataclasses.replace(
        settings,
        schema_dirpath=str(tmp_path / "schema"),
        checkpoint_dirpath=str(tmp_path / "ckpt"),
        model_dirpath=str(tmp_path / "model"),
        index_dirpath=str(tmp_path / "index"),
    )
    mesh = make_mesh(*shape, devices=["cpu"] * 8)
    results = modelling_runner(settings, mesh=mesh,
                               distributed_index=distributed, device="cpu")
    assert results["final"][50] > results["initial"][50], results
    assert abs(results["final"][50] - single["final"][50]) < 0.15
    for tower in ("query_tower", "candidate_tower"):
        got = load_pytree_npz(f"{settings.model_dirpath}/{tower}/params.npz")
        want = load_pytree_npz(
            f"{pipeline[0].model_dirpath}/{tower}/params.npz")
        assert jax.tree_util.tree_map(np.shape, got) == (
            jax.tree_util.tree_map(np.shape, want))
    again = evaluation_runner(
        dataclasses.replace(settings, index_dirpath=str(tmp_path / "idx2")),
        mesh=mesh, distributed_index=distributed, device="cpu")
    assert again == results["final"]
