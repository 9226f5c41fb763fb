"""Quickstart: open a knowledge base and retrieve documents.

Mirrors the reference's ``examples/quickstart.py``: point the KB at a local
path, a ``.gz``, or an ``http(s)`` URL of a published knowledge base; the
embedding function is restored from the database itself.

To run against a real provider, set OPENAI_API_KEY (or run an Ollama
server) and swap the embedding function below.
"""

from svs_tpu import KB, make_mock_embeddings_func
from svs_tpu.utils import load_env

load_env()  # pick up OPENAI_API_KEY etc. from a local .env, if present

# For a remote, published KB you'd write e.g.:
#   kb = KB('https://example.com/dad_jokes.sqlite.gz')
kb = KB("quickstart.sqlite", make_mock_embeddings_func(), force_fresh_db=True)

with kb.bulk_add_docs() as add_doc:
    add_doc("The GPU's tensor cores multiply small matrix tiles.")
    add_doc("SQLite is a single-file embedded database.")
    add_doc("Cosine similarity of unit vectors is a dot product.")

for hit in kb.retrieve("how does the GPU multiply matrices?", n=2):
    print(f"{hit['score']:+.4f}  {hit['doc']['text']}")

kb.close(vacuum=True, also_gzip=True)  # publishes quickstart.sqlite.gz
