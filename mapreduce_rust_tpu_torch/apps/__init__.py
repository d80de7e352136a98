"""App registry of the port: apps are selected by name at the CLI/driver
boundary (the port of ``mapreduce_rust_tpu/apps/__init__.py``)."""

from mapreduce_rust_tpu_torch.apps.base import App  # noqa: F401
from mapreduce_rust_tpu_torch.apps.grep import Grep  # noqa: F401
from mapreduce_rust_tpu_torch.apps.inverted_index import InvertedIndex  # noqa: F401
from mapreduce_rust_tpu_torch.apps.join import Join  # noqa: F401
from mapreduce_rust_tpu_torch.apps.sort import Sort  # noqa: F401
from mapreduce_rust_tpu_torch.apps.top_k import TopK  # noqa: F401
from mapreduce_rust_tpu_torch.apps.word_count import WordCount  # noqa: F401

REGISTRY: dict[str, type[App]] = {
    "word_count": WordCount,
    "inverted_index": InvertedIndex,
    "top_k": TopK,
    "grep": Grep,
    "sort": Sort,
    "join": Join,
}


def get_app(name: str, **kwargs) -> App:
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown app {name!r}; have {sorted(REGISTRY)}") from None
    return cls(**kwargs)
