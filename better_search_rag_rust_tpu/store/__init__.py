from .vectorstore import (  # noqa: F401
    GLOBAL_STORE_NAME,
    VectorStore,
    global_store,
    global_store_path,
    local_store,
    local_store_path,
    merge_vector_stores,
)
from .device_store import DeviceStore  # noqa: F401
