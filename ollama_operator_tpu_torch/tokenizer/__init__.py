from .tokenizer import Tokenizer, StreamDecoder  # noqa: F401
