"""ETL primitives and stages without pandas: tables of numpy columns
(``transformations.py``), ``etl_runner`` and ``build_schema_runner``
(``runner.py``)."""

from hm_retrieval_tpu_torch.etl.transformations import (
    ListColumn,
    add_history_column,
    date_filter,
    load_dataframe,
    merge_inner,
    save_dataframe,
)

__all__ = [
    "ListColumn",
    "add_history_column",
    "date_filter",
    "load_dataframe",
    "merge_inner",
    "save_dataframe",
]
