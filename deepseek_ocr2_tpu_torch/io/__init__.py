from .safetensors_torch import (  # noqa: F401
    DtypePolicy,
    LoadReport,
    inspect_safetensors,
    load_flat,
    save_flat,
)
