"""Reference state → port state, for holding the port against the JAX
package on the same inputs.

Every function takes the reference's structures with numpy leaves
(``jax.tree.map(np.asarray, x)`` on the reference side) and returns the
port's tensors. Parameter-shaped pytrees become flat rows through a
:class:`~repro_torch.common.pytree.PlaneLayout`, in the reference's
leaf order, so both sides then compute the same thing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import PlaneLayout
from repro_torch.core.knowledge import KnowledgeStore, SparseInFlight
from repro_torch.rl.a2c import A2CState


def _t(x, device, dtype=None) -> torch.Tensor:
    # a copy: arrays taken from JAX are read-only, which torch refuses
    # to alias without a warning
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    return _t(tree, device)


def flat_params(tree, lead: int = 1, layout: Optional[PlaneLayout] = None,
                device="cpu") -> Tuple[torch.Tensor, PlaneLayout]:
    """A parameter-shaped pytree whose leaves carry ``lead`` leading
    axes (agents, slots, ...) → ((*lead, P) fp32 rows, its layout)."""
    torch_tree = _tree_to_torch(tree, device)
    layout = layout or PlaneLayout.from_tree(torch_tree, lead=lead)
    return layout.flatten(torch_tree).to(torch.float32), layout


def adamw_state(state, layout: PlaneLayout, device="cpu") -> dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` stacked over
    agents → flat moments and an (n,) int32 step count."""
    return {"m": flat_params(state["m"], layout=layout, device=device)[0],
            "v": flat_params(state["v"], layout=layout, device=device)[0],
            "count": _t(state["count"], device, torch.int32)}


def a2c_state(state, layout: PlaneLayout, device="cpu") -> A2CState:
    """A reference ``A2CState`` stacked over agents (AdamW optimiser)."""
    return A2CState(
        params=flat_params(state.params, layout=layout, device=device)[0],
        opt_state=adamw_state(state.opt_state, layout, device),
        step=_t(state.step, device, torch.int32))


def knowledge_store(store, layout: PlaneLayout, device="cpu"
                    ) -> KnowledgeStore:
    """A reference fp32 ``KnowledgeStore`` stacked over agents (leaves
    (n, m, *param)) → flat (n, m, P) planes."""
    return KnowledgeStore(
        grads=flat_params(store.grads, layout=layout, device=device)[0],
        T=_t(store.T, device, torch.float32),
        R=_t(store.R, device, torch.float32),
        valid=_t(store.valid, device, torch.bool),
        ptr=_t(store.ptr, device, torch.int32))


def sparse_inflight(flight, layout: PlaneLayout, device="cpu"
                    ) -> SparseInFlight:
    """A reference fp32 ``SparseInFlight`` (leaves (n, k, D+2, *param))
    → flat (n, k, D+2, P) planes."""
    return SparseInFlight(
        grads=flat_params(flight.grads, layout=layout, device=device)[0],
        T=_t(flight.T, device, torch.float32),
        R=_t(flight.R, device, torch.float32),
        valid=_t(flight.valid, device, torch.bool))
