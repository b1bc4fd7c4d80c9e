"""Tiny overrides that keep every width's kind and every path of a cell
but fit a CPU test: 3,000 customers, 5,000 articles, joint 64."""

TINY = {
    "n_customers": 3000,
    "n_articles": 5000,
    "query_features": [{"name": "customer_id", "rows": 3000, "width": 128}],
    "candidate_features": [
        {"name": "article_id", "rows": 5000, "width": 128},
        {"name": "product_type_name", "rows": 130, "width": 16},
        {"name": "colour_group_name", "rows": 50, "width": 8},
    ],
    "candidate_batch_size": 1000,
    "joint_embedding_size": 64,
}


def overrides(cell: str):
    """(config overrides, traffic overrides) of a cell at the tiny size."""
    if "retrieve" in cell:
        return ({**TINY, "index": {"class": "BruteForceIndex", "k": 100,
                                   "method": "pallas"}},
                {"batch": 64, "k": 100, "check_batches": 3,
                 "trace_seconds": 0.3})
    return TINY, {"batch": 256, "pool_batches": 8, "trace_seconds": 0.3}
