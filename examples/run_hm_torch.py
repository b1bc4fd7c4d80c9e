"""Reference-parity entrypoint for the H&M Kaggle dataset, through the port.

A port of ``examples/run_hm.py``: the same flags, stage slicing, settings,
feature set, training config and run-shape overrides (ref: main.py:11-111:
date ranges 2019-09-20..2020-08-20 train / 2020-08-21..2020-09-21 test,
B=512 Adagrad lr=0.05, 1 epoch, ks=[10,100,1000]), run by the five stages
of ``hm_retrieval_tpu_torch`` without pandas, with these differences:

- ``--device`` in place of ``--platform``: the card by default (an error
  where CUDA is absent), or ``cpu``;
- the splits are ``.npz`` tables (the card's machine has no pyarrow); the
  shards equal ``run_hm.py``'s bit for bit;
- ``--sample`` draws ``df.sample(frac, random_state=0)``'s rows with numpy
  and writes them with the port's CSV writer, byte for byte pandas' file;
- the mesh flags build ``make_mesh(data, model)`` over the visible cards,
  or over ``["cpu"] * (data * model)`` with ``--device cpu``.

    python examples/run_hm_torch.py --data-dir /path/to/hm_csvs --workdir out/

Expects transactions_train.csv, articles.csv, customers.csv in --data-dir.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

STAGES = ("etl", "schema", "shards", "model", "baseline")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument(
        "--sample",
        type=float,
        default=None,
        help="optional transaction fraction (BASELINE config[0]: 0.01)",
    )
    ap.add_argument(
        "--stages",
        default="etl,schema,shards,model,baseline",
        help="comma-separated subset of pipeline stages to run (each stage "
        "reads its inputs from the workdir), or 'all'",
    )
    ap.add_argument(
        "--resume",
        action="store_true",
        help="resume training from the latest checkpoint",
    )
    ap.add_argument(
        "--export-savedmodel",
        action="store_true",
        help="also export the TF-Serving SavedModel (needs tensorflow)",
    )
    ap.add_argument(
        "--mesh-data",
        type=int,
        default=None,
        help="data-parallel mesh axis size (default: no mesh, single "
        "device; use with --mesh-model for 2-D meshes)",
    )
    ap.add_argument(
        "--mesh-model",
        type=int,
        default=1,
        help="model-parallel mesh axis size for row-sharded tables",
    )
    ap.add_argument(
        "--sharded-features",
        default="",
        help="comma-separated embedding tables to row-shard over the model "
        "axis (e.g. customer_id,article_id; needs --mesh-model > 1)",
    )
    ap.add_argument(
        "--index-type",
        choices=["brute_force", "quantized"],
        default="brute_force",
        help="retrieval index family: exact brute force (reference "
        "behavior) or the int8 quantized scan",
    )
    ap.add_argument(
        "--steps-per-dispatch",
        type=int,
        default=None,
        help="train steps per chunked call (K batches a call; identical "
        "numerics, ragged epoch tails dropped)",
    )
    ap.add_argument(
        "--etl-chunk-rows",
        type=int,
        default=None,
        metavar="N",
        help="stream the transactions CSV through the ETL join N rows at a "
        "time (identical outputs)",
    )
    ap.add_argument(
        "--schema-stream-rows",
        type=int,
        default=None,
        metavar="N",
        help="build vocabs/logQ in a streaming pass of N split rows at a "
        "time (identical schema artifact)",
    )
    ap.add_argument(
        "--shard-stream-rows",
        type=int,
        default=None,
        metavar="N",
        help="stream the shards stage N split rows at a time (identical "
        "shard files)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device (e.g. cpu); default: the card, which must be "
        "present",
    )
    ap.add_argument(
        "--history",
        type=int,
        default=0,
        metavar="N",
        help="add a purchase_history SEQUENCE query feature holding each "
        "customer's last N article ids (vocab shared with article_id; "
        "BASELINE config[3]). 0 = the reference feature set exactly",
    )
    ap.add_argument(
        "--history-pooling",
        choices=["mean", "attention"],
        default="mean",
        help="pooling for the history token embeddings",
    )
    ap.add_argument(
        "--distributed-index",
        action="store_true",
        help="row-shard the retrieval catalog over the mesh's model axis "
        "and serve eval through the sharded top-k merge",
    )
    args = ap.parse_args(argv)
    stages = set(args.stages.split(","))
    if stages == {"all"}:
        stages = set(STAGES)
    unknown = stages - set(STAGES)
    if unknown:
        ap.error(f"unknown stages: {sorted(unknown)}")
    return args, stages


def sample_transactions(src: str, dst: str, frac: float) -> None:
    """``pd.read_csv(src).sample(frac=frac, random_state=0).to_csv(dst,
    index=False)`` without pandas: ``round(frac * n)`` rows drawn by
    ``RandomState(0).choice(n, replace=False)``, in draw order."""
    import numpy as np

    from hm_retrieval_tpu_torch.etl.transformations import (
        load_dataframe,
        save_dataframe,
        table_len,
        take,
    )

    table = load_dataframe(src)
    n = table_len(table)
    rows = np.random.RandomState(0).choice(n, size=round(frac * n),
                                           replace=False)
    save_dataframe(take(table, rows), dst)


def make_settings(args, transactions_filepath: str):
    """The stages' settings: the raw CSVs of ``--data-dir``, the reference's
    dates and every artifact under ``--workdir``."""
    from hm_retrieval_tpu_torch.utils.settings import Settings

    d = args.workdir
    return Settings(
        transactions_filepath=transactions_filepath,
        articles_filepath=os.path.join(args.data_dir, "articles.csv"),
        customers_filepath=os.path.join(args.data_dir, "customers.csv"),
        # ref: main.py:11-30
        train_start_date="2019-09-20",
        train_end_date="2020-08-20",
        test_start_date="2020-08-21",
        test_end_date="2020-09-21",
        train_data_filepath=f"{d}/processed/train.npz",
        test_data_filepath=f"{d}/processed/test.npz",
        schema_dirpath=f"{d}/schema",
        train_shards_dirpath=f"{d}/shards/train",
        test_shards_dirpath=f"{d}/shards/test",
        candidate_shards_dirpath=f"{d}/shards/candidates",
        model_dirpath=f"{d}/artifacts/model",
        index_dirpath=f"{d}/artifacts/index",
        baseline_index_dirpath=f"{d}/artifacts/baseline_index",
        checkpoint_dirpath=f"{d}/artifacts/checkpoints",
        tensorboard_logs_dir=f"{d}/logs",
        history_max_len=args.history or None,
        etl_chunk_rows=args.etl_chunk_rows,
        schema_stream_rows=args.schema_stream_rows,
        shard_stream_rows=args.shard_stream_rows,
        savedmodel_dirpath=(
            f"{d}/artifacts/savedmodel" if args.export_savedmodel else None
        ),
    )


def main(argv=None):
    args, stages = parse_args(argv)

    from hm_retrieval_tpu_torch.device import resolve_device
    from hm_retrieval_tpu_torch.runners import (
        baseline_modelling_runner,
        build_schema_runner,
        etl_runner,
        modelling_runner,
        shard_writer_runner,
    )
    from hm_retrieval_tpu_torch.schema import (
        Feature,
        FeatureFamily,
        FeatureKind,
        ModelConfig,
        Schema,
        TrainingConfig,
    )

    device = resolve_device(args.device)  # raises before any stage runs
    d = args.workdir
    tx = os.path.join(args.data_dir, "transactions_train.csv")
    if args.sample:
        os.makedirs(d, exist_ok=True)
        sampled = os.path.join(d, "transactions_sampled.csv")
        sample_transactions(tx, sampled, args.sample)
        tx = sampled

    settings = make_settings(args, tx)

    # Feature set per ref main.py:32-111 (the duplicate product_type_name
    # entry in the reference is collapsed: Schema rejects duplicates).
    query_features = [
        Feature(
            "customer_id",
            FeatureKind.CATEGORICAL,
            FeatureFamily.QUERY,
            embedding_size=128,
        ),
    ]
    if args.history:
        query_features.append(
            Feature(
                "purchase_history",
                FeatureKind.SEQUENCE,
                FeatureFamily.QUERY,
                embedding_size=128,
                max_len=args.history,
                shared_vocab_with="article_id",
                pooling=args.history_pooling,
            )
        )
    schema = Schema(
        features=query_features
        + [
            Feature("FN", FeatureKind.NUMERIC, FeatureFamily.QUERY),
            Feature("age", FeatureKind.NUMERIC, FeatureFamily.QUERY,
                    standardize=True),
            Feature("article_id", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=128),
            Feature("product_type_name", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=16),
            Feature("product_group_name", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=8),
            Feature("colour_group_name", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=8),
            Feature("department_name", FeatureKind.CATEGORICAL,
                    FeatureFamily.CANDIDATE, embedding_size=16),
        ],
        model_config=ModelConfig(
            joint_embedding_size=128,
            ks=[10, 100, 1000],  # ref: main.py:107
            index_type=args.index_type,
        ),
        training_config=TrainingConfig(
            train_batch_size=512,  # ref: main.py:98
            test_batch_size=2048,
            candidate_batch_size=10_000,
            epochs=1 if args.epochs is None else args.epochs,
            optimizer_name="adagrad",
            optimizer_kwargs={"learning_rate": 0.05},
            sharded_embedding_features=[
                f for f in args.sharded_features.split(",") if f
            ],
            steps_per_dispatch=(
                1 if args.steps_per_dispatch is None
                else args.steps_per_dispatch
            ),
        ),
        candidate_id_col="article_id",
    )

    mesh = None
    if (args.mesh_data is not None or args.mesh_model > 1
            or args.distributed_index):
        from hm_retrieval_tpu_torch.parallel import make_mesh

        if device.type == "cpu":
            data = 1 if args.mesh_data is None else args.mesh_data
            mesh = make_mesh(data=data, model=args.mesh_model,
                             devices=["cpu"] * (data * args.mesh_model))
        else:  # the visible cards: one card takes no --mesh-data 4
            mesh = make_mesh(data=args.mesh_data, model=args.mesh_model)

    if "etl" in stages:
        etl_runner(settings)
    if "schema" in stages:
        build_schema_runner(settings, schema)
    if "shards" in stages:
        shard_writer_runner(settings)
    results = baseline = None
    if "model" in stages:
        # run-shape knobs given on THIS command line take effect even when
        # the schema stage (which snapshots TrainingConfig) ran in an
        # earlier invocation, logged loudly by the runner
        overrides = {}
        if "schema" not in stages:
            if args.epochs is not None:
                overrides["epochs"] = args.epochs
            if args.steps_per_dispatch is not None:
                overrides["steps_per_dispatch"] = args.steps_per_dispatch
        results = modelling_runner(
            settings,
            mesh=mesh,
            resume=args.resume,
            distributed_index=args.distributed_index,
            training_overrides=overrides,
            device=device,
        )
    if "baseline" in stages:
        baseline = baseline_modelling_runner(settings, device=device)
    print("\n=== Results ===")
    if results:
        print(f"untrained model recall: {results['initial']}")
        print(f"trained model recall:   {results['final']}")
    if baseline:
        print(f"popularity baseline:    {baseline}")
    return results, baseline


if __name__ == "__main__":
    main()
