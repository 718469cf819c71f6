"""The port's package exports against the JAX package's: the top level, ops
and geometry export every name that their JAX counterparts export, and each
name resolves to the port's own object. ``ops.pallas_supported`` is a JAX
platform switch that the port replaces with ``kernel_supported``."""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# names of a JAX module's __all__ that the port has by another name
NOT_PORTED = {"raytrace_tpu.ops": {"pallas_supported"}}


def test_top_level_exports_what_jax_exports():
    import raytrace_tpu
    import raytrace_tpu_torch
    from raytrace_tpu_torch.geometry import kerr
    from raytrace_tpu_torch.rays import RayBatch

    assert set(raytrace_tpu_torch.__all__) == {"kerr", "RayBatch", "__version__"}
    assert set(raytrace_tpu_torch.__all__) == set(raytrace_tpu.__all__)
    assert raytrace_tpu_torch.kerr is kerr
    assert raytrace_tpu_torch.RayBatch is RayBatch
    assert raytrace_tpu_torch.__version__ == raytrace_tpu.__version__


@pytest.mark.parametrize("module", ["raytrace_tpu.ops", "raytrace_tpu.geometry"])
def test_subpackage_exports_what_jax_exports(module):
    jax_mod = importlib.import_module(module)
    port_mod = importlib.import_module(module.replace("raytrace_tpu", "raytrace_tpu_torch", 1))
    missing = set(jax_mod.__all__) - NOT_PORTED.get(module, set()) - set(port_mod.__all__)
    assert not missing, f"{port_mod.__name__} lacks {sorted(missing)}"
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name


@pytest.mark.parametrize("module, name, home", [
    ("raytrace_tpu_torch.ops", "pixel_accumulate", "raytrace_tpu_torch.ops.reductions"),
    ("raytrace_tpu_torch.geometry", "rel_disc_area", "raytrace_tpu_torch.geometry.disc"),
])
def test_new_exports_are_the_ported_functions(module, name, home):
    jax_mod = importlib.import_module(module.replace("raytrace_tpu_torch", "raytrace_tpu", 1))
    assert name in jax_mod.__all__
    port_mod = importlib.import_module(module)
    assert name in port_mod.__all__
    assert getattr(port_mod, name) is getattr(importlib.import_module(home), name)
