"""PyTorch/CUDA port of the two-tower retrieval framework, for one NVIDIA H100.

The JAX package ``hm_retrieval_tpu`` beside this one is the reference; this
package imports none of it (nor JAX) and mirrors its module names so each
counterpart is easy to find. Ported so far, the serving path:

    host-side string encode -> query tower -> exact or int8 top-k over the
    catalog (streaming bin-max passes, hand-written CUDA kernels) -> string
    decode

and training on one device:

    ShardDataset.iter_batches -> device_feed -> train step (in-batch
    softmax with logQ, optional uniform negatives; sparse row Adagrad for
    the tables, or the hand-written dense Adagrad / Adam)

and the stages in front of it, without pandas:

    raw CSVs -> etl_runner (join, purchase history, date split) ->
    build_schema_runner (vocabs, stats, logQ) -> shard_writer_runner

Every entry point takes ``device=None``, which means ``"cuda"``, and raises
when CUDA is absent unless the caller asks for ``device="cpu"``. On the CPU
each kernel wrapper runs its plain PyTorch version; there is no automatic
fallback from the card to the CPU anywhere.
"""

from hm_retrieval_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
