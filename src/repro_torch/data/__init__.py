from .synth import meter_data, star_schema, token_corpus, zipf_tokens
from .tokenstore import TokenStore

__all__ = ["TokenStore", "meter_data", "star_schema", "token_corpus",
           "zipf_tokens"]
