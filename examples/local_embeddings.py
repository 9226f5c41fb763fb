"""Fully on-device pipeline: embed AND retrieve on the same device.

The reference can only embed through remote HTTP APIs; here the encoder
itself runs under JAX on the retrieval device via
``make_local_embeddings_func`` — no network, no API key, no per-token
billing.  Point it at any Hugging Face Flax encoder (a hub name like
``"BAAI/bge-small-en-v1.5"`` or a local checkpoint directory).

This example builds a tiny random-weight BERT on the fly so it runs
hermetically; swap ``MODEL`` for a real checkpoint to get meaningful
semantics.  The provider's params persist in the database, so a consumer
re-opening the published file needs no code — the same checkpoint is
loaded automatically.
"""

import tempfile
from pathlib import Path

from svs_tpu import KB, make_local_embeddings_func

# --- a hermetic stand-in checkpoint (use a real encoder in production) --
MODEL = Path(tempfile.mkdtemp()) / "tiny-encoder"


def _make_tiny_checkpoint() -> None:
    from transformers import BertConfig, BertTokenizer, FlaxBertModel

    MODEL.mkdir(parents=True)
    vocab = (
        "[PAD] [UNK] [CLS] [SEP] [MASK] the a of is unit matrix gpu "
        "tensor cores small tiles sqlite database cosine similarity dot product "
        "vectors multiply matrices single file embedded how does"
    ).split()
    (MODEL / "vocab.txt").write_text("\n".join(vocab) + "\n")
    BertTokenizer(str(MODEL / "vocab.txt")).save_pretrained(str(MODEL))
    config = BertConfig(
        vocab_size=len(vocab),
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=2,
        intermediate_size=128,
        max_position_embeddings=64,
    )
    FlaxBertModel(config, seed=0).save_pretrained(str(MODEL))


_make_tiny_checkpoint()

# --- the actual pipeline ------------------------------------------------
embed = make_local_embeddings_func(
    str(MODEL),
    pooling="mean",
    max_length=32,
    compute_dtype="float32",  # 'bfloat16' for tensor-core rate
)

kb = KB("local_kb.sqlite", embed, force_fresh_db=True)

with kb.bulk_add_docs() as add_doc:
    add_doc("The GPU's tensor cores multiply small matrix tiles.")
    add_doc("SQLite is a single-file embedded database.")
    add_doc("Cosine similarity of unit vectors is a dot product.")

for hit in kb.retrieve("how does the GPU multiply matrices?", n=2):
    print(f"{hit['score']:+.4f}  {hit['doc']['text']}")

kb.close(vacuum=True)

# A consumer needs no embedding function: the local-provider params are
# stored in the file, and the same checkpoint is loaded on first use.
kb2 = KB("local_kb.sqlite")
print("reopened:", kb2.retrieve("embedded database", n=1)[0]["doc"]["text"])
kb2.close()
