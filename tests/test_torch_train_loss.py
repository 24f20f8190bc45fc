"""The port's training loss and its gradients (``repro_torch.models.model
.loss_fn`` under autograd) against ``jax.value_and_grad`` of the JAX
package's ``loss_fn``, on the same stacked parameters (the reference's
``init_params``, carried over by ``interop.train_state_from_numpy``) and the
same seeded batches, in float32, for the reduced configs without MoE
layers (GQA full and sliding-window, RG-LRU, SSD, embeds and M-RoPE
inputs); parameter counts of all ten; the per-layer view of the stacked
tree against ``prefill``.  ``test_torch_train_moe.py`` holds the MoE
architectures.  Tolerance: ``test_torch_train_common.TOL`` of max(1, max
|reference|) per metric and gradient leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402
from test_torch_train_common import (  # noqa: E402
    SEQ, TOL, _configs, _reference_params, assert_matches, make_batch, run_both,
)

DENSE = sorted(a for a, c in ARCHS.items() if c.moe is None)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    assert_matches(*run_both(arch))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams, host = _reference_params(arch)
    params = train_state_from_numpy(host, "cpu")
    assert TM.count_params(params) == JM.count_params(jparams)
    assert TM.active_params(tcfg, params) == JM.active_params(jcfg, jparams)
    mine = TM.init_train_params(torch.Generator().manual_seed(0), tcfg)
    assert [(p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(mine)] == [
        (p, tuple(x.shape), x.dtype) for p, x in flatten_with_path(params)]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "recurrentgemma-9b", "mamba2-1.3b"])
def test_per_layer_view_serves_the_stacked_tree(arch):
    """``per_layer`` of the stacked tree holds views of it and prefills as
    ``params_from_numpy`` of the same reference tree does; ``stack_layers``
    gives the stacked tree back."""
    _, tcfg = _configs(arch)
    _, host = _reference_params(arch)
    stacked = train_state_from_numpy(host, "cpu")
    view = TM.per_layer(stacked, tcfg)
    served = params_from_numpy(host, tcfg, "cpu")
    for a, b in zip(leaves(view), leaves(served)):
        assert torch.equal(a, b)
    assert view["layers"][0]["norm1"]["scale"].data_ptr() == \
        stacked["seg0"]["sub0"]["norm1"]["scale"].data_ptr()
    for a, b in zip(leaves(TM.stack_layers(served, tcfg)), leaves(stacked)):
        assert torch.equal(a, b)
    tokens = torch.from_numpy(make_batch(tcfg)["tokens"])
    with torch.no_grad():
        hidden, *_ = TM.trunk_train(stacked, {"tokens": tokens}, tcfg)
        last = TM.unembed(stacked["embed"], hidden[:, -1:], tcfg)[:, 0]
        _, logits = TM.prefill(view, {"tokens": tokens}, tcfg, SEQ + 2)
    np.testing.assert_allclose(last.numpy(), logits.numpy(), atol=TOL, rtol=TOL)
