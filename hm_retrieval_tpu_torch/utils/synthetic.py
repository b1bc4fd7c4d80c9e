"""Synthetic H&M-shaped data generation, without pandas.

Counterpart of the JAX package's ``utils/synthetic.py``: the same
``default_rng(seed)`` draws in the same order, and CSVs byte-identical to
the ones pandas writes there (``age`` as pandas writes a float, ``"16.0"``;
dates ``%Y-%m-%d``; transactions sorted stably by date). Article popularity
is Zipf-distributed and each customer favours two product types, so a
trained two-tower model has something to learn beyond popularity.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

START = np.datetime64("2020-01-01", "D")


def _write_csv(path: str, header: str, rows) -> None:
    with open(path, "w") as f:
        f.write(header + "\n")
        for block in iter(lambda: list(itertools.islice(rows, 1 << 20)), []):
            f.write("\n".join(block) + "\n")


def _day(offset: int) -> str:
    return str(START + np.timedelta64(offset, "D"))


def generate_hm_like_csvs(
    dirpath: str,
    n_transactions: int = 50_000,
    n_customers: int = 2_000,
    n_articles: int = 1_000,
    n_days: int = 60,
    n_product_types: int = 20,
    seed: int = 0,
    preference_strength: float = 1.0,
) -> dict:
    """Writes transactions.csv / articles.csv / customers.csv; returns the
    filepaths plus the date ranges of the train and test splits."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)

    article_ids = np.array([f"art_{i:06d}" for i in range(n_articles)])
    customer_ids = np.array([f"cust_{i:07d}" for i in range(n_customers)])
    ages = rng.integers(16, 80, n_customers).astype(float)

    # Zipf article popularity.
    pop = 1.0 / np.arange(1, n_articles + 1) ** 1.1
    pop /= pop.sum()

    # Latent customer -> product-type preference (2 favourite types each).
    fav_types = rng.integers(0, n_product_types, size=(n_customers, 2))
    art_type = np.arange(n_articles) % n_product_types

    cust_idx = rng.integers(0, n_customers, n_transactions)
    art_idx = rng.choice(n_articles, n_transactions, p=pop)
    # With probability tied to preference_strength, resample the article
    # from the customer's favourite types.
    prefer = rng.random(n_transactions) < (
        preference_strength / (1 + preference_strength)
    )
    fav0 = np.where(prefer, fav_types[cust_idx, 0], -1)
    fav1 = np.where(prefer, fav_types[cust_idx, 1], -1)
    for t in range(n_product_types):
        arts_t = np.where(art_type == t)[0]
        p_t = pop[arts_t] / pop[arts_t].sum()
        rows = np.where((fav0 == t) | (fav1 == t))[0]
        if len(rows):
            art_idx[rows] = rng.choice(arts_t, len(rows), p=p_t)

    day = rng.integers(0, n_days, n_transactions)
    order = np.argsort(day, kind="stable")  # sort_values("t_dat", "stable")
    dates = (START + day[order]).astype(str)

    paths = {
        "transactions": os.path.join(dirpath, "transactions.csv"),
        "articles": os.path.join(dirpath, "articles.csv"),
        "customers": os.path.join(dirpath, "customers.csv"),
    }
    _write_csv(paths["transactions"], "t_dat,customer_id,article_id",
               map(",".join, zip(dates.tolist(),
                                 customer_ids[cust_idx[order]].tolist(),
                                 article_ids[art_idx[order]].tolist())))
    _write_csv(paths["articles"],
               "article_id,product_type_name,colour_group_name",
               (f"{a},type_{i % n_product_types},colour_{i % 10}"
                for i, a in enumerate(article_ids.tolist())))
    _write_csv(paths["customers"], "customer_id,age",
               map(",".join, zip(customer_ids.tolist(),
                                 map(repr, ages.tolist()))))
    split = int(n_days * 0.8)
    paths.update(
        {
            "train_start": _day(0),
            "train_end": _day(split - 1),
            "test_start": _day(split),
            "test_end": _day(n_days),
        }
    )
    return paths
