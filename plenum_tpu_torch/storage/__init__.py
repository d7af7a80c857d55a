from .kv_store import KeyValueStorage
from .kv_memory import KvMemory
from .kv_file import KvFile
from .kv_chunked import KvChunked


def init_kv_store(backend: str, path=None, name: str = "kv") -> KeyValueStorage:
    """Factory mirroring storage/helper.py initKeyValueStorage in the reference."""
    if backend == "memory":
        return KvMemory()
    if backend == "file":
        assert path is not None, "file backend needs a path"
        return KvFile(path, name)
    if backend == "chunked":
        assert path is not None, "chunked backend needs a path"
        return KvChunked(path, name)
    raise ValueError(f"unknown kv backend {backend!r}")
