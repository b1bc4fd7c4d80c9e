"""ETL primitives. Ported: ``load_dataframe`` and ``date_filter``, the part
the popularity baseline reads (``runners/baseline.py``)."""

from hm_retrieval_tpu_torch.etl.transformations import date_filter, load_dataframe

__all__ = ["date_filter", "load_dataframe"]
