"""Per-env physics step with contacts: the PyTorch port against the JAX
package on the CPU (see test_torch_perenv_step.py for the comparison).

Two boxes stacked on a floor, each just inside the contact margin of what it
rests on: floor contact rows and member contact rows are active, so both the
push pass and the velocity sweep move the bodies. Two members wedged edge on
edge: the member narrowphase picks the edge-edge axis (a one-point manifold
with its own feature id).
"""

import torch

from test_torch_perenv_step import compare_perenv, stacked_boxes_model, wedge_model


def test_stacked_boxes_match_jax():
    sp = compare_perenv(stacked_boxes_model())
    # floor and member contacts really engaged
    assert float(sp.contact_lambda[..., 0].sum()) > 0.0
    assert float(sp.dyn_lambda[:, 0].sum()) > 0.0
    assert int((sp.dyn_vid >= 0).sum()) > 0


def test_edge_on_edge_wedge_matches_jax():
    sp = compare_perenv(wedge_model())
    # the wedged pair keeps a live member contact through the 3 steps
    assert int((sp.dyn_vid >= 0).sum()) >= 1
    assert bool(torch.isfinite(sp.pos).all())
