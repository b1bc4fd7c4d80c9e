"""End-to-end demo of the PyTorch port on synthetic H&M-shaped data.

    python examples/run_synthetic_torch.py --workdir /tmp/hm_demo [--device cpu]

Runs all five stages through ``hm_retrieval_tpu_torch`` alone: etl ->
schema -> shards -> train+eval -> baseline, then prints the trained model's
Recall@K next to the popularity baseline. The first three stages need no
pandas; the splits are ``.npz`` tables. It takes the flags of
``examples/run_synthetic.py``, with ``--device`` in place of
``--platform``: the card by default (an error where CUDA is absent), or
``cpu``. The mesh flags build a one-process mesh of the device repeated.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument(
        "--device",
        default=None,
        help="torch device for the modelling stages (e.g. cpu); default: "
        "the card, which must be present",
    )
    ap.add_argument("--transactions", type=int, default=200_000)
    ap.add_argument("--customers", type=int, default=5_000)
    ap.add_argument("--articles", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument(
        "--steps-per-dispatch",
        type=int,
        default=1,
        help="train steps per chunked call (identical numerics, ragged "
        "epoch tails dropped)",
    )
    ap.add_argument(
        "--with-history",
        action="store_true",
        help="sequence-aware query tower over last-16 purchase history "
        "(BASELINE config[3])",
    )
    ap.add_argument(
        "--history-pooling",
        choices=["mean", "attention"],
        default="mean",
        help="how history token embeddings pool to one vector",
    )
    ap.add_argument(
        "--uniform-negatives",
        type=int,
        default=0,
        help="extra uniform negatives per step (BASELINE config[4])",
    )
    ap.add_argument(
        "--index-type",
        choices=["brute_force", "quantized"],
        default="brute_force",
        help="retrieval index family: exact brute force or int8 quantized",
    )
    ap.add_argument(
        "--export-savedmodel",
        action="store_true",
        help="also export the TF-Serving SavedModel (needs tensorflow, "
        "checked before any stage)",
    )
    ap.add_argument(
        "--mesh-data",
        type=int,
        default=None,
        help="data-parallel mesh axis size (default: no mesh)",
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
        help="comma-separated embedding tables to row-shard over the "
        "model axis (needs --mesh-model > 1)",
    )
    ap.add_argument(
        "--distributed-index",
        action="store_true",
        help="row-shard the retrieval catalog over the mesh's model axis",
    )
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

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
    from hm_retrieval_tpu_torch.serving import require_tensorflow
    from hm_retrieval_tpu_torch.utils.settings import Settings
    from hm_retrieval_tpu_torch.utils.synthetic import generate_hm_like_csvs

    device = resolve_device(args.device)  # raises before any stage runs
    if args.export_savedmodel:
        require_tensorflow()
    d = args.workdir
    raw = generate_hm_like_csvs(
        os.path.join(d, "raw"),
        n_transactions=args.transactions,
        n_customers=args.customers,
        n_articles=args.articles,
    )

    settings = Settings(
        transactions_filepath=raw["transactions"],
        articles_filepath=raw["articles"],
        customers_filepath=raw["customers"],
        train_start_date=raw["train_start"],
        train_end_date=raw["train_end"],
        test_start_date=raw["test_start"],
        test_end_date=raw["test_end"],
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
        profile_steps=None,
        history_max_len=16 if args.with_history else None,
        savedmodel_dirpath=(f"{d}/artifacts/savedmodel"
                            if args.export_savedmodel else None),
    )
    settings.to_json(f"{d}/settings.json")

    query_features = [
        Feature(
            "customer_id",
            FeatureKind.CATEGORICAL,
            FeatureFamily.QUERY,
            embedding_size=64,
        ),
    ]
    if args.with_history:
        query_features.append(
            Feature(
                "purchase_history",
                FeatureKind.SEQUENCE,
                FeatureFamily.QUERY,
                embedding_size=64,
                max_len=16,
                shared_vocab_with="article_id",
                pooling=args.history_pooling,
            )
        )
    schema = Schema(
        features=query_features
        + [
            Feature(
                "article_id",
                FeatureKind.CATEGORICAL,
                FeatureFamily.CANDIDATE,
                embedding_size=64,
            ),
            Feature(
                "product_type_name",
                FeatureKind.CATEGORICAL,
                FeatureFamily.CANDIDATE,
                embedding_size=16,
            ),
            Feature(
                "colour_group_name",
                FeatureKind.CATEGORICAL,
                FeatureFamily.CANDIDATE,
                embedding_size=8,
            ),
        ],
        model_config=ModelConfig(
            joint_embedding_size=64,
            ks=[10, 100],
            query_tower_units=[128],
            candidate_tower_units=[128],
            index_type=args.index_type,
        ),
        training_config=TrainingConfig(
            train_batch_size=args.batch_size,
            test_batch_size=2048,
            candidate_batch_size=2048,
            epochs=args.epochs,
            optimizer_name="adagrad",
            optimizer_kwargs={"learning_rate": 0.05},
            num_uniform_negatives=args.uniform_negatives,
            steps_per_dispatch=args.steps_per_dispatch,
            sharded_embedding_features=[
                f for f in args.sharded_features.split(",") if f
            ],
        ),
        candidate_id_col="article_id",
    )

    mesh = None
    if (
        args.mesh_data is not None
        or args.mesh_model > 1
        or args.distributed_index
    ):
        from hm_retrieval_tpu_torch.parallel import make_mesh

        data = 1 if args.mesh_data is None else args.mesh_data
        mesh = make_mesh(
            data=data,
            model=args.mesh_model,
            devices=[device] * (data * args.mesh_model),
        )

    etl_runner(settings)
    build_schema_runner(settings, schema)
    shard_writer_runner(settings)
    results = modelling_runner(
        settings,
        mesh=mesh,
        distributed_index=args.distributed_index,
        device=device,
    )
    baseline = baseline_modelling_runner(settings, device=device)

    print("\n=== Results ===")
    print(f"untrained model recall: {results['initial']}")
    print(f"trained model recall:   {results['final']}")
    print(f"popularity baseline:    {baseline}")
    return results, baseline


if __name__ == "__main__":
    main()
