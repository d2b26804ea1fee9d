"""Weight carry-over between the JAX reference's param trees and the
port's, and :class:`TransformerLM`, the port's model as an ``nn.Module``.

A param tree is nested dicts, lists and tuples (``stages`` is a list of
tuples, one dict a layer kind) with arrays at the leaves, in the
reference's shape and leaf names.  :func:`params_from_numpy` takes the
reference's ``init_params`` tree as numpy arrays
(``jax.tree.map(np.asarray, params)``) to the port's tree on a device;
:func:`params_to_numpy` goes back.  Both keep the nesting and the names.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

from . import serving, transformer
from .config import ModelConfig
from .transformer import Params, tree_map


def params_from_numpy(tree: Any, device=None) -> Params:
    """The reference's param tree, as numpy arrays, on ``device`` (``cuda``
    unless given) with the same nesting and leaf names; every leaf owns
    its buffer."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree: Params) -> Any:
    """The port's param tree as host numpy arrays, nesting kept."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


class _Tree(nn.Module):
    """One dict, list or tuple node of a param tree; its tensor leaves are
    parameters (no gradient) named by their key or index, so a module's
    ``state_dict`` keys are the tree paths (``stages.0.0.attn.wq``)."""

    def __init__(self, node):
        super().__init__()
        self._node_type = type(node)
        items = node.items() if isinstance(node, dict) else enumerate(node)
        self._node_keys = []
        for key, value in items:
            name = str(key)
            self._node_keys.append(name)
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, _Tree(value))

    def tree(self):
        vals = [getattr(self, k) for k in self._node_keys]
        vals = [v.tree() if isinstance(v, _Tree) else v for v in vals]
        if self._node_type is dict:
            return dict(zip(self._node_keys, vals))
        return self._node_type(vals)


class TransformerLM(_Tree):
    """The port's LM over a param tree in the reference's layout (its
    ``state_dict`` keys are the tree paths): ``forward``, ``decode_step``
    and ``generate`` call :func:`transformer.forward`,
    :func:`serving.decode_step` and :func:`serving.greedy_generate` with
    :attr:`params`."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    @property
    def params(self) -> Params:
        """The param tree over this module's parameters (no copies)."""
        return self.tree()

    def forward(self, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor] = None,
                last_only: bool = False):
        """(logits, hidden, moe_aux) of :func:`transformer.forward`."""
        return transformer.forward(self.params, self.cfg, tokens, frontend_embeds, ep_axis=None,
                                   last_only=last_only)

    def decode_step(self, cache: serving.Cache, token: torch.Tensor):
        return serving.decode_step(self.params, self.cfg, cache, token, ep_axis=None)

    def generate(self, prompt: torch.Tensor, steps: int, s_cap: int,
                 frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return serving.greedy_generate(self.params, self.cfg, prompt, steps, s_cap,
                                       frontend_embeds=frontend_embeds)
