"""Every name the JAX package registers (models, losses, datasets,
transforms, hooks, testers) is registered in the port, so a config
written for the JAX package builds in the port and no ported name is
dropped unseen. Under a second."""

import pytest

pytest.importorskip("torch")


def _registries():
    import scenesplat_tpu.data as jdata
    import scenesplat_tpu.engines.hooks as jhooks
    import scenesplat_tpu.engines.test as jtest
    import scenesplat_tpu.models as jmodels
    import scenesplat_tpu_torch.data as tdata
    import scenesplat_tpu_torch.engines.hooks as thooks
    import scenesplat_tpu_torch.engines.test as ttest
    import scenesplat_tpu_torch.models as tmodels
    from scenesplat_tpu.data.transforms import TRANSFORMS as JT
    from scenesplat_tpu.models.losses.builder import LOSSES as JL
    from scenesplat_tpu_torch.data.transforms import TRANSFORMS as TT
    from scenesplat_tpu_torch.models.losses import LOSSES as TL

    return dict(models=(jmodels.MODELS, tmodels.MODELS), losses=(JL, TL),
                datasets=(jdata.DATASETS, tdata.DATASETS), transforms=(JT, TT),
                hooks=(jhooks.HOOKS, thooks.HOOKS), testers=(jtest.TESTERS, ttest.TESTERS))


@pytest.mark.parametrize("kind", ["models", "losses", "datasets", "transforms", "hooks",
                                  "testers"])
def test_port_registers_every_jax_name(kind):
    jax_registry, port_registry = _registries()[kind]
    jax_names = set(jax_registry._module_dict)
    assert jax_names, kind
    missing = sorted(jax_names - set(port_registry._module_dict))
    assert not missing, f"{kind} the JAX package registers and the port does not: {missing}"
