from .safetensors_torch import (  # noqa: F401
    DtypePolicy,
    LoadReport,
    load_flat,
    save_flat,
)
