"""Command-line applications (``python -m raytrace_tpu_torch.apps.<name>``)."""
