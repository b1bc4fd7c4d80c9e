"""Export the retrieval path as a TF-Serving SavedModel.

Counterpart of the JAX package's ``serving/savedmodel_export.py``. The
reference's deployment artifact is a TF SavedModel whose concrete serving
function takes ``(None, 1)`` string feature tensors and returns ``(B, k)``
string candidate ids (ref: pkg/modelling/indices/brute_force.py:108-114,
pkg/modelling/models/abstract_keras_model.py:109-131). The JAX package
lowers its tower through ``jax2tf``, which the port cannot import, so the
port writes the same function in TensorFlow ops over its weights, carried
to host numpy through ``models/bridge.py``:

    string features -> tf.lookup.StaticHashTable (vocab -> int id, 0 = OOV)
                    -> the embedding gathers; a sequence's masked mean or
                       attention pool (an all-pad row pools to 0); a
                       numeric standardized, NaN -> 0, clipped to float32
                    -> Dense + ReLU on every layer
                    -> fp32 q @ embᵀ + bias (-inf on pad rows)
                    -> tf.math.top_k (ties to the lower index, as
                       lax.top_k) -> the id gather
                    -> tf.gather over the candidate vocab (id -> string,
                       0 and ids outside the vocab -> "<OOV>")

with the JAX export's signature: ``serving_default``, a ``(None, 1)``
string or float32 input a feature (``(None, max_len)`` strings for a
sequence, right-padded with ``""``), output key ``candidate_ids``. A
quantized index exports its fp32 rescore table, or without one its
dequantized catalog, the ranking its ``rescore=False`` path serves.

TensorFlow is imported inside ``export_index_savedmodel`` only: importing
this module (or the package) never loads it. ``validate_exportable_schema``
and ``require_tensorflow`` are host-only and import nothing, so the modelling
runner checks both before any step.
"""

from __future__ import annotations

import importlib.util
import logging

import numpy as np

from hm_retrieval_tpu_torch.models.bridge import params_to_numpy
from hm_retrieval_tpu_torch.schema.features import FeatureKind
from hm_retrieval_tpu_torch.schema.schema import Schema

logger = logging.getLogger(__name__)

OOV_TOKEN = "<OOV>"


def validate_exportable_schema(schema: Schema) -> None:
    """Raise if the schema cannot be exported as a SavedModel.

    Pure host-side check (no TF import) so runners can fail fast BEFORE
    training instead of crashing at export time after all epochs ran.
    """
    for f in list(schema.query_features) + [schema.candidate_id_feature]:
        if f.kind in (FeatureKind.CATEGORICAL, FeatureKind.SEQUENCE):
            if f.vocab is None:
                raise ValueError(
                    f"SavedModel export: feature {f.name!r} has no "
                    "built vocab (run build_schema_runner first)"
                )
        elif f.standardize and (f.mean is None or f.std is None):
            raise ValueError(
                f"SavedModel export: numeric feature {f.name!r} is "
                "standardized but its train statistics are not built"
            )


def require_tensorflow() -> None:
    """Raise ``ImportError`` naming tensorflow where it cannot be imported
    (as on the card's machine), without importing it."""
    if importlib.util.find_spec("tensorflow") is None:
        raise ImportError(
            "the SavedModel export needs tensorflow, which cannot be imported "
            "here")


def _host(t) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _catalog(index):
    """(padded fp32 embeddings, score bias, ids) of a single-device index
    on the host."""
    if index.embeddings is not None:
        emb = _host(index.embeddings).astype(np.float32)
    else:  # dequantized codes: the ranking of the rescore=False path
        emb = (_host(index.codes).astype(np.float32)
               * _host(index.scales).astype(np.float32)[:, None])
    return (emb, _host(index._score_bias).astype(np.float32),
            _host(index.identifiers).astype(np.int32))


def export_index_savedmodel(schema: Schema, query_tower, index,
                            out_dir: str) -> None:
    """Write a servable SavedModel to ``out_dir``.

    ``query_tower``: a ``Tower`` or its weights as a JAX-layout numpy tree
    (``models/bridge.py``); ``index``: a single-device ``BruteForceIndex``
    or ``QuantizedIndex`` (a sharded index exports through ``to_local()``).
    """
    import tensorflow as tf

    validate_exportable_schema(schema)
    query_features = schema.query_features
    tree = (query_tower if isinstance(query_tower, dict)
            else params_to_numpy(query_tower))
    emb, bias, ids = _catalog(index)
    k = index.k

    def weight(a):
        return tf.Variable(np.asarray(a, np.float32), trainable=False)

    module = tf.Module()
    module._embeddings = {n: weight(a) for n, a in tree["embeddings"].items()}
    module._dense = [(weight(layer["w"]), weight(layer["b"]))
                     for layer in tree["dense"]]
    module._attention = {n: weight(a)
                         for n, a in tree.get("attention", {}).items()}
    module._emb = weight(emb)
    module._bias = weight(bias)
    module._ids = tf.Variable(ids, trainable=False)

    # String-edge lookup tables (one per categorical/sequence feature),
    # the encode contract of Feature.encode: vocab[i] -> i+1, OOV -> 0
    # (sequence pads "" are OOV too, masked by pooling).
    tables = {}
    for f in query_features:
        if f.kind in (FeatureKind.CATEGORICAL, FeatureKind.SEQUENCE):
            vocab = np.asarray(f.vocab, dtype=str)
            tables[f.name] = tf.lookup.StaticHashTable(
                tf.lookup.KeyValueTensorInitializer(
                    keys=tf.constant(list(vocab)),
                    values=tf.constant(
                        np.arange(1, len(vocab) + 1, dtype=np.int32)),
                ),
                default_value=0,
            )
    module._tables = tables

    # id -> string decode table for the returned candidates
    # (Feature.decode: padded vocab with "<OOV>" at 0).
    cid = schema.candidate_id_feature
    module._decode = tf.constant(
        [OOV_TOKEN] + np.asarray(cid.vocab, dtype=str).tolist())

    numeric_stats = {
        f.name: (float(f.mean) if f.standardize else 0.0,
                 float(f.std) if f.standardize else 1.0)
        for f in query_features if f.kind == FeatureKind.NUMERIC
    }

    input_signature = [{
        f.name: tf.TensorSpec(
            shape=((None, f.max_len) if f.kind == FeatureKind.SEQUENCE
                   else (None, 1)),
            dtype=(tf.float32 if f.kind == FeatureKind.NUMERIC
                   else tf.string),
            name=f.name,
        )
        for f in query_features
    }]

    def pool(f, tokens, rows):
        """(b, L) ids, (b, L, E) rows -> (b, E), pad id 0 masked
        (models/embedding.py::pool_sequence)."""
        valid = tf.not_equal(tokens, 0)
        mask = tf.cast(valid, tf.float32)
        if f.pooling == "attention":
            scores = tf.einsum("ble,e->bl", rows, module._attention[f.name])
            scores = tf.where(valid, scores, tf.fill(tf.shape(scores),
                                                     float("-inf")))
            top = tf.maximum(tf.reduce_max(scores, axis=1, keepdims=True),
                             -1e30)
            z = tf.exp(scores - top) * mask
            denom = tf.maximum(tf.reduce_sum(z, axis=1, keepdims=True), 1e-30)
            return tf.einsum("bl,ble->be", z / denom, rows)
        denom = tf.maximum(tf.reduce_sum(mask, axis=1, keepdims=True), 1.0)
        return tf.reduce_sum(rows * mask[:, :, None], axis=1) / denom

    def serve(raw):
        parts = []
        for f in query_features:
            if f.kind == FeatureKind.SEQUENCE:
                tokens = module._tables[f.name].lookup(raw[f.name])
                parts.append(pool(f, tokens, tf.gather(
                    module._embeddings[f.name], tokens)))
                continue
            x = tf.squeeze(raw[f.name], axis=1)
            if f.kind == FeatureKind.CATEGORICAL:
                parts.append(tf.gather(module._embeddings[f.name],
                                       module._tables[f.name].lookup(x)))
                continue
            mean, std = numeric_stats[f.name]
            x = (x - mean) / std
            # Feature.transform_numeric's np.nan_to_num: NaN -> 0 after
            # standardization, +/-inf squashed to the float32 extremes
            x = tf.where(tf.math.is_nan(x), tf.zeros_like(x), x)
            parts.append(tf.clip_by_value(x, tf.float32.min,
                                          tf.float32.max)[:, None])
        q = tf.concat(parts, axis=-1)
        for w, b in module._dense:
            q = tf.nn.relu(tf.matmul(q, w) + b)
        scores = tf.matmul(q, module._emb, transpose_b=True) + module._bias
        _, top = tf.math.top_k(scores, k)
        top_ids = tf.gather(module._ids, top)
        # Feature.decode: ids outside [0, len(vocab)] decode to "<OOV>"
        safe_ids = tf.where(
            (top_ids >= 0)
            & (top_ids < tf.size(module._decode, out_type=top_ids.dtype)),
            top_ids,
            tf.zeros_like(top_ids),
        )
        return {"candidate_ids": tf.gather(module._decode, safe_ids)}

    module.serve = tf.function(serve, input_signature=input_signature)
    concrete = module.serve.get_concrete_function()
    tf.saved_model.save(module, out_dir,
                        signatures={"serving_default": concrete})
    logger.info("Exported TF-Serving SavedModel to %s (k=%d, %d candidates)",
                out_dir, k, index.num_candidates)
