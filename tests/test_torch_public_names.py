"""The port's public names against the JAX package's: the ``__all__`` of
the top-level package, ``mapping``, ``ops``, ``runtime``, ``parallel``
and ``baseline`` hold every name the JAX one holds, except those still
to be ported, listed here by name with the ROADMAP.md item that brings
them (none now). Every listed name resolves, and the package carries the
JAX package's ``__version__``."""

import importlib

import pytest

# name -> the ROADMAP.md queue 1 item that ports it
STILL_TO_PORT: dict[str, dict[str, str]] = {}


@pytest.mark.parametrize("sub", ["", "mapping", "ops", "runtime", "parallel", "baseline"])
def test_public_names_cover_the_jax_package(sub):
    suffix = f".{sub}" if sub else ""
    jax_mod = importlib.import_module("monte_carlo_localization_tpu" + suffix)
    port = importlib.import_module("monte_carlo_localization_tpu_torch" + suffix)
    missing = set(jax_mod.__all__) - set(port.__all__)
    assert missing == set(STILL_TO_PORT.get(sub, {})), sorted(missing)
    for name in port.__all__:
        assert hasattr(port, name), f"{port.__name__}.__all__ names {name!r}, which is absent"


def test_cast_rays_and_version_import():
    import monte_carlo_localization_tpu as jpkg
    import monte_carlo_localization_tpu_torch as pkg
    from monte_carlo_localization_tpu_torch.ops import cast_rays
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays as defined

    assert cast_rays is defined
    assert pkg.__version__ == jpkg.__version__ == "0.1.0"
