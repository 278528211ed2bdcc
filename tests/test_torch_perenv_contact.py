"""Per-env physics step with contacts: the PyTorch port against the JAX
package on the CPU (see test_torch_perenv_step.py for the comparison).

Two boxes stacked on a floor, each just inside the contact margin of what it
rests on: floor contact rows and member contact rows are active, so both the
push pass and the velocity sweep move the bodies. Two members wedged edge on
edge: the member narrowphase picks the edge-edge axis (a one-point manifold
with its own feature id). Both also in the scheduled and shuffled:7 row
visit orders, against the same order of JAX.
"""

import pytest
import torch

from test_torch_perenv_step import compare_perenv, stacked_boxes_model, wedge_model
from test_torch_step import ROW_ORDERS

OTHER_ORDERS = [o for o in ROW_ORDERS if o != "canonical"]


def test_stacked_boxes_match_jax():
    check_stacked_boxes("canonical")


@pytest.mark.parametrize("row_order", OTHER_ORDERS)
def test_stacked_boxes_match_jax_in_row_order(row_order):
    check_stacked_boxes(row_order)


def check_stacked_boxes(row_order):
    sp = compare_perenv(stacked_boxes_model(row_order=row_order))
    # floor and member contacts really engaged
    assert float(sp.contact_lambda[..., 0].sum()) > 0.0
    assert float(sp.dyn_lambda[:, 0].sum()) > 0.0
    assert int((sp.dyn_vid >= 0).sum()) > 0


def test_edge_on_edge_wedge_matches_jax():
    check_wedge("canonical")


@pytest.mark.parametrize("row_order", OTHER_ORDERS)
def test_edge_on_edge_wedge_matches_jax_in_row_order(row_order):
    check_wedge(row_order)


def check_wedge(row_order):
    sp = compare_perenv(wedge_model(row_order=row_order))
    # the wedged pair keeps a live member contact through the 3 steps
    assert int((sp.dyn_vid >= 0).sum()) >= 1
    assert bool(torch.isfinite(sp.pos).all())
