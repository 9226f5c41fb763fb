"""Local embedding provider: run the encoder ON this machine's JAX device.

The reference can only embed through remote HTTP services
(``svs/embeddings/__init__.py:19-31`` offers mock/openai/ollama); this
provider makes the framework self-contained on the accelerator — the same device that
scores the corpus computes the embeddings, with no network, no API key,
and no per-token billing.

Any Hugging Face Flax encoder checkpoint works (a hub name or a local
directory): the model loads lazily on first use, the forward pass is
``jax.jit``-compiled once per (bucket, max_length) shape — inputs are
padded to power-of-two batch buckets so arbitrary caller batch sizes hit
a handful of cached compilations — and pooling + L2 normalization run
on-device.  Outputs are float32 lists matching the
:data:`~svs_tpu.types.EmbeddingFunc` contract, and the
``__embedding_func_params__`` tag round-trips through a database like
every other provider (``svs/kb.py:896-922``).

Precision: ``compute_dtype='bfloat16'`` (the default) runs the matmuls
on the tensor cores at full rate with f32 parameters left intact; pass
``'float32'`` for bit-stable CPU-vs-device parity at lower throughput.
The compute dtype changes the embedding VALUES, so it is part of the
provider's identity params.
"""

from __future__ import annotations

import asyncio
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..types import EmbeddingFunc
from .base import EMBEDDINGS_MAX_CACHE_SIZE

_POOLINGS = ("mean", "cls")


def _buckets(batch_size: int) -> List[int]:
    """Power-of-two padding buckets up to ``batch_size`` (ascending);
    the last bucket always equals ``batch_size`` so every chunk fits."""
    out = [1]
    while out[-1] < batch_size:
        out.append(min(out[-1] * 2, batch_size))
    return out


class _LocalEncoder:
    """Lazily-loaded Flax encoder + tokenizer with a jitted, bucketed
    forward pass.  One instance per provider factory call; the heavy
    imports (transformers, jax trace) happen on first ``embed``."""

    def __init__(
        self,
        model: str,
        pooling: str,
        max_length: int,
        compute_dtype: str,
        normalize: bool,
        batch_size: int,
    ) -> None:
        self.model_name = model
        self.pooling = pooling
        self.max_length = max_length
        self.compute_dtype = compute_dtype
        self.normalize = normalize
        self.batch_size = batch_size
        self._loaded: Optional[Tuple[Any, Callable[..., Any]]] = None
        # threading (not asyncio) lock: one provider instance may serve
        # several KBs on different event loops (the sync facade runs a
        # private loop thread), and embed() executes in an executor.
        # The result LRU lives on the encoder (not at module level) so
        # the loaded model weights die with the provider, and so the
        # single-flight story needs no loop-bound asyncio primitives.
        self._lock = threading.Lock()
        self._cache: "OrderedDict[Tuple[str, ...], np.ndarray]" = (
            OrderedDict()
        )

    def _load(self) -> Tuple[Any, Callable[..., Any]]:
        if self._loaded is not None:
            return self._loaded
        import jax
        import jax.numpy as jnp
        from transformers import AutoTokenizer, FlaxAutoModel

        dtype = jnp.bfloat16 if self.compute_dtype == "bfloat16" else (
            jnp.float32
        )
        tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        flax_model = FlaxAutoModel.from_pretrained(
            self.model_name, dtype=dtype
        )
        pooling = self.pooling
        normalize = self.normalize

        @jax.jit
        def forward(
            params: Any, ids: jax.Array, mask: jax.Array
        ) -> jax.Array:
            out = flax_model(
                input_ids=ids,
                attention_mask=mask,
                params=params,
                train=False,
            )
            hidden = out.last_hidden_state.astype(jnp.float32)
            if pooling == "cls":
                vec = hidden[:, 0, :]
            else:  # mask-weighted mean over real tokens
                m = mask.astype(jnp.float32)[:, :, None]
                vec = jnp.sum(hidden * m, axis=1) / jnp.maximum(
                    jnp.sum(m, axis=1), 1.0
                )
            if normalize:
                vec = vec / jnp.maximum(
                    jnp.linalg.norm(vec, axis=1, keepdims=True), 1e-12
                )
            return vec

        self._loaded = (tokenizer, lambda ids, mask: forward(
            flax_model.params, ids, mask
        ))
        return self._loaded

    def embed(self, texts: Tuple[str, ...]) -> np.ndarray:
        """Tokenize + forward ``texts`` in bucketed device batches;
        returns ``[len(texts), dim]`` float32.  Synchronous — callers
        run it in an executor; the lock serializes load + forward per
        encoder (one compile stream) and makes identical concurrent
        requests single-flight through the LRU."""
        with self._lock:
            hit = self._cache.get(texts)
            if hit is not None:
                self._cache.move_to_end(texts)
                return hit
            out = self._embed_locked(texts)
            self._cache[texts] = out
            while len(self._cache) > EMBEDDINGS_MAX_CACHE_SIZE:
                self._cache.popitem(last=False)
            return out

    def _embed_locked(self, texts: Tuple[str, ...]) -> np.ndarray:
        tokenizer, forward = self._load()
        vecs: List[np.ndarray] = []
        buckets = _buckets(self.batch_size)
        i = 0
        while i < len(texts):
            chunk = list(texts[i : i + self.batch_size])
            i += len(chunk)
            bucket = next(b for b in buckets if b >= len(chunk))
            toks = tokenizer(
                chunk + [""] * (bucket - len(chunk)),
                padding="max_length",
                truncation=True,
                max_length=self.max_length,
                return_tensors="np",
            )
            out = forward(
                toks["input_ids"].astype(np.int32),
                toks["attention_mask"].astype(np.int32),
            )
            vecs.append(np.asarray(out, dtype=np.float32)[: len(chunk)])
        if not vecs:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(vecs, axis=0)


def make_local_embeddings_func(
    model: str,
    pooling: str = "mean",
    max_length: int = 128,
    compute_dtype: str = "bfloat16",
    normalize: bool = True,
    batch_size: int = 128,
) -> EmbeddingFunc:
    """Build an on-device embedding function from a Flax encoder.

    ``model`` is a Hugging Face hub name or a local directory holding a
    Flax checkpoint + tokenizer.  ``pooling`` is ``'mean'``
    (mask-weighted token mean) or ``'cls'``.  ``compute_dtype`` selects
    the forward-pass matmul precision (``'bfloat16'`` for tensor-core rate,
    ``'float32'`` for exactness) and is part of the provider identity —
    it changes the produced vectors.  ``batch_size`` and the internal
    power-of-two padding buckets only affect throughput.
    """
    if pooling not in _POOLINGS:
        raise ValueError(
            f"pooling must be one of {_POOLINGS}, got {pooling!r}"
        )
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(
            "compute_dtype must be 'bfloat16' or 'float32', got "
            f"{compute_dtype!r}"
        )
    if max_length < 1:
        raise ValueError("max_length must be >= 1")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")

    encoder = _LocalEncoder(
        model, pooling, max_length, compute_dtype, normalize, batch_size
    )
    params: Dict[str, Any] = {
        "provider": "local",
        "model": model,
        "pooling": pooling,
        "max_length": max_length,
        "compute_dtype": compute_dtype,
        "normalize": normalize,
    }

    async def local_embeddings(
        list_of_strings: List[str],
    ) -> List[List[float]]:
        assert isinstance(list_of_strings, list)
        assert all(isinstance(s, str) for s in list_of_strings)
        if not list_of_strings:
            return []
        # Device work runs in an executor so the event loop stays
        # responsive; caching + single-flight live on the encoder
        # (thread-safe, loop-agnostic — see _LocalEncoder).
        loop = asyncio.get_running_loop()
        matrix = await loop.run_in_executor(
            None, encoder.embed, tuple(list_of_strings)
        )
        return [row.tolist() for row in matrix]

    setattr(local_embeddings, "__embedding_func_params__", params)
    return local_embeddings
