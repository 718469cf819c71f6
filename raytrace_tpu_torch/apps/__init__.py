"""Command-line applications (``python -m raytrace_tpu_torch.apps.<name>``).

Each app runs on the card unless ``--device=cpu`` asks for the CPU, where
the plain march runs: ``app_device`` reads the key (default ``cuda``) and
``require_device`` refuses a CUDA device that is not there, so no app
carries on on the CPU by itself.
"""

import torch


def app_device(cfg) -> torch.device:
    """The run configuration's ``device`` (default ``cuda``)."""
    return torch.device(cfg.get("device", str, "cuda"))


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no card
    is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the apps run on the card; "
                           "pass --device=cpu to run the plain march on the CPU")
    return device
