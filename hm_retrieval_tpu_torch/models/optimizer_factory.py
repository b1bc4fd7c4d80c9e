"""Optimizer registry: Adagrad and Adam written by hand, in optax's order.

Counterpart of ``hm_retrieval_tpu/models/optimizer_factory.py``: the same
name lookup and the mandatory ``learning_rate``. ``torch.optim`` is not used:
its Adagrad adds eps outside the square root, where optax (and the Keras
legacy Adagrad the reference runs) adds it inside.

Each optimizer updates a flat ``{name: parameter}`` dict in place, so a
1.37M-row table is not copied every step. Its state mirrors optax's state
tree field by field, keyed by the same names (``models/bridge.py`` carries
it to and from the JAX package's tree):

- Adagrad, optax ``scale_by_rss`` then ``scale(-lr)``::

      acc <- g*g + acc                           (acc starts at 0.1)
      u   =  where(acc > 0, rsqrt(acc + eps), 0) * g
      p   <- p + u * (-lr)

- Adam, optax ``scale_by_adam`` (eps_root inside the root, the step count
  int32 on the device, bias corrections computed there too)::

      mu <- (1 - b1) * g + b1 * mu;  nu <- (1 - b2) * g*g + b2 * nu
      u  =  (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t) + eps_root) + eps)
      p  <- p + u * (-lr)

No update reads a value back to the host. Each parameter is updated on its
own device with its state beside it, so the parameters of one update may
lie on several devices (a mesh's table shards); Adam's step count and bias
corrections live on the first parameter's device and are copied to the
others.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]

_INT32_MAX = 2**31 - 1


class AdagradState(NamedTuple):
    sum_of_squares: Params


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, on the parameters' device
    mu: Params
    nu: Params


class Adagrad:
    def __init__(
        self,
        learning_rate: float,
        initial_accumulator_value: float = 0.1,
        eps: float = 1e-7,
    ):
        self.learning_rate = float(learning_rate)
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.eps = float(eps)

    def init(self, params: Params) -> AdagradState:
        return AdagradState(
            {
                n: torch.full_like(p.detach(), self.initial_accumulator_value)
                for n, p in params.items()
            }
        )

    @torch.no_grad()
    def update_(
        self, grads: Params, state: AdagradState, params: Params
    ) -> AdagradState:
        for name, p in params.items():
            g = grads[name]
            acc = state.sum_of_squares[name]
            acc.add_(g * g)
            u = torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0) * g
            p.add_(u * -self.learning_rate)
        return state


class Adam:
    def __init__(
        self,
        learning_rate: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        eps_root: float = 0.0,
    ):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)

    def init(self, params: Params) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: torch.zeros_like(p.detach()) for n, p in params.items()},
            nu={n: torch.zeros_like(p.detach()) for n, p in params.items()},
        )

    @torch.no_grad()
    def update_(
        self, grads: Params, state: AdamState, params: Params
    ) -> AdamState:
        count = state.count
        count.copy_(torch.where(count < _INT32_MAX, count + 1, count))
        t = count.to(torch.float32)
        corrections = {count.device: (1 - torch.pow(self.b1, t),
                                      1 - torch.pow(self.b2, t))}
        for name, p in params.items():
            if p.device not in corrections:
                corrections[p.device] = tuple(
                    c.to(p.device) for c in corrections[count.device])
            correction1, correction2 = corrections[p.device]
            g = grads[name]
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / correction1) / (
                torch.sqrt(nu / correction2 + self.eps_root) + self.eps
            )
            p.add_(u * -self.learning_rate)
        return state


_REGISTRY = {
    "adagrad": Adagrad,
    "adam": Adam,
}


class OptimizerFactory:
    @staticmethod
    def get_optimizer(name: str, optimizer_kwargs: Dict):
        key = name.lower()
        if key not in _REGISTRY:
            raise ValueError(
                f"unknown optimizer {name!r}; supported: {sorted(_REGISTRY)}"
            )
        if "learning_rate" not in optimizer_kwargs:
            raise ValueError("optimizer_kwargs must include learning_rate")
        return _REGISTRY[key](**optimizer_kwargs)
