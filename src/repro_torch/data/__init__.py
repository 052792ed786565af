from .synth import star_schema, token_corpus, zipf_tokens
from .tokenstore import TokenStore

__all__ = ["TokenStore", "star_schema", "token_corpus", "zipf_tokens"]
