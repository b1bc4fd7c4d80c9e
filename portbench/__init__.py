"""The benchmark of ``hm_retrieval_tpu_torch`` on NVIDIA H100 cards: one
cell of ``BENCHMARK.json`` a run (``python3 -m portbench.run``), driven by
the data files under ``configs/``, ``traffic/``, ``limits/`` and
``metrics/``. Nothing here imports JAX or the JAX package."""
