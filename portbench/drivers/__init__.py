"""One module per configuration's entry into the port (see ``harness.py``)."""

import importlib


def load_port(app: str, device: str) -> bool:
    """Import the port's ``app`` module and, on the card, load the march
    library it launches, building it with nvcc where the checkout has none
    yet. True where nvcc ran."""
    importlib.import_module(app)
    if not str(device).startswith("cuda"):
        return False
    from raytrace_tpu_torch.ops import march_kernel

    built = bool(march_kernel.build())
    march_kernel.load()
    return built
