"""Symmetric autoencoder for latent features (counterpart of
``anovos_tpu/models/autoencoder.py``).

n → 2n → n → k → n → 2n → n: Dense + BatchNorm + LeakyReLU(0.3) on every
hidden layer, a linear bottleneck and output, Adam on the MSE, all in
true f32 (TF32 off).  The BatchNorm is written out, not ``nn.BatchNorm1d``,
to keep the JAX model's numbers: ε = 1e-3, the *biased* batch variance
both to normalize and in the running value, running update 0.99·old +
0.01·batch.

The JAX model is a parameter tree {layer: {"w" (n_in, n_out), "b",
"bn": {"scale", "bias", "mean", "var"}}}; :func:`params_from_jax` and
:func:`params_to_jax` convert it to and from this module's
``state_dict`` (``nn.Linear`` keeps its weight as (n_out, n_in)).  The
``model.npz`` layout is the JAX package's, so each package loads the
other's model.  Initial weights and batch orders come from a seeded
``torch.Generator``, so they differ from the JAX package's draws.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from anovos_tpu_torch.ops.mxu import true_f32

logger = logging.getLogger(__name__)

_LAYERS = ("enc1", "enc2", "bottleneck", "dec1", "dec2", "out")
_BN_LAYERS = ("enc1", "enc2", "dec1", "dec2")
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
LEAKY_SLOPE = 0.3


class _BatchNorm(nn.Module):
    """Batch normalization with the JAX model's conventions (module doc)."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.training:
            mu = h.mean(dim=0)
            var = h.var(dim=0, unbiased=False)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mu)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mu, var = self.mean, self.var
        return (h - mu) / torch.sqrt(var + BN_EPS) * self.scale + self.bias


class AENet(nn.Module):
    """The network; ``encode`` gives the bottleneck, ``forward`` the
    reconstruction."""

    def __init__(self, n_inputs: int, n_bottleneck: int):
        super().__init__()
        n, k = n_inputs, n_bottleneck
        dims = {"enc1": (n, 2 * n), "enc2": (2 * n, n), "bottleneck": (n, k),
                "dec1": (k, n), "dec2": (n, 2 * n), "out": (2 * n, n)}
        self.dense = nn.ModuleDict({name: nn.Linear(i, o) for name, (i, o) in dims.items()})
        self.bn = nn.ModuleDict({name: _BatchNorm(dims[name][1]) for name in _BN_LAYERS})

    def _block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return nn.functional.leaky_relu(self.bn[name](self.dense[name](x)), LEAKY_SLOPE)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense["bottleneck"](self._block(self._block(x, "enc1"), "enc2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense["out"](self._block(self._block(self.encode(x), "dec1"), "dec2"))


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (numpy or jax arrays) → an ``AENet``
    ``state_dict`` of CPU f32 tensors (weights transposed)."""
    sd = {}
    for name in _LAYERS:
        layer = tree[name]
        sd[f"dense.{name}.weight"] = torch.from_numpy(np.array(layer["w"], np.float32).T.copy())
        sd[f"dense.{name}.bias"] = torch.from_numpy(np.array(layer["b"], np.float32))
        if name in _BN_LAYERS:
            for key in ("scale", "bias", "mean", "var"):
                sd[f"bn.{name}.{key}"] = torch.from_numpy(np.array(layer["bn"][key], np.float32))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """An ``AENet`` ``state_dict`` → the JAX parameter tree of numpy f32
    arrays (weights as (n_in, n_out))."""
    host = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state_dict.items()}
    tree = {}
    for name in _LAYERS:
        tree[name] = {"w": np.ascontiguousarray(host[f"dense.{name}.weight"].T),
                      "b": host[f"dense.{name}.bias"]}
        if name in _BN_LAYERS:
            tree[name]["bn"] = {key: host[f"bn.{name}.{key}"] for key in ("scale", "bias", "mean", "var")}
    return tree


def epoch_order(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """One epoch's row order: a permutation of range(n) drawn from
    ``generator``."""
    return torch.randperm(n, generator=generator, device=generator.device).to(device)


class AutoEncoder:
    """n → 2n → n → k → n → 2n → n symmetric autoencoder; the fitted
    parameters are an :class:`AENet` on the data's device."""

    def __init__(self, n_inputs: int, n_bottleneck: int, seed: int = 0):
        self.n_inputs = int(n_inputs)
        self.n_bottleneck = int(n_bottleneck)
        self.seed = seed
        # per epoch of the last fit: training MSE of its last step and,
        # with validation data, the validation MSE after it
        self.history: List[dict] = []

    # -- parameters ------------------------------------------------------
    def init_params(self, device=None) -> AENet:
        """He-normal weights (σ = √(2 / n_in)) from ``torch.Generator``
        seeded with ``seed``, zero biases, BatchNorm scale 1, bias 0, mean
        0, var 1."""
        net = AENet(self.n_inputs, self.n_bottleneck)
        gen = torch.Generator().manual_seed(self.seed)
        with torch.no_grad():
            for name in _LAYERS:
                lin = net.dense[name]
                n_out, n_in = lin.weight.shape
                lin.weight.copy_(torch.randn((n_out, n_in), generator=gen) * float(np.sqrt(2.0 / n_in)))
                lin.bias.zero_()
        return net.to(device) if device is not None else net

    def net_from_state(self, state_dict: Dict[str, torch.Tensor], device=None) -> AENet:
        net = AENet(self.n_inputs, self.n_bottleneck)
        net.load_state_dict(state_dict)
        return net.to(device) if device is not None else net

    # -- forward ---------------------------------------------------------
    def latent(self, params: AENet, x: torch.Tensor) -> torch.Tensor:
        params.eval()
        with torch.no_grad(), true_f32():
            return params.encode(x)

    def reconstruct(self, params: AENet, x: torch.Tensor) -> torch.Tensor:
        params.eval()
        with torch.no_grad(), true_f32():
            return params(x)

    # -- training --------------------------------------------------------
    @staticmethod
    def train_steps(params: AENet, optimizer: torch.optim.Optimizer, batches) -> List[torch.Tensor]:
        """One Adam step per batch in ``batches`` (train-mode BatchNorm);
        returns each step's loss (a 0-d tensor, not synchronized)."""
        params.train()
        losses = []
        with true_f32():
            for batch in batches:
                optimizer.zero_grad(set_to_none=True)
                loss = torch.mean((params(batch) - batch) ** 2)
                loss.backward()
                optimizer.step()
                losses.append(loss.detach())
        return losses

    def fit(
        self,
        X: torch.Tensor,
        epochs: int = 100,
        batch_size: int = 256,
        learning_rate: float = 1e-3,
        validation_X: Optional[torch.Tensor] = None,
        verbose: bool = False,
        seed: int = 0,
    ) -> AENet:
        """Minibatch Adam (β 0.9/0.999, ε 1e-8) from ``init_params``: each
        epoch takes ``n // batch_size`` batches of a fresh permutation
        (the remainder is dropped).  X must be standardized and imputed."""
        params = self.init_params(X.device)
        optimizer = torch.optim.Adam(params.parameters(), lr=learning_rate)
        n = X.shape[0]
        steps = max(n // batch_size, 1)
        gen = torch.Generator(device=X.device).manual_seed(seed)
        self.history = []
        for ep in range(epochs):
            perm = epoch_order(n, gen, X.device)
            losses = self.train_steps(params, optimizer,
                                      (X[perm[s * batch_size:(s + 1) * batch_size]] for s in range(steps)))
            rec = {"epoch": ep, "train_mse": float(losses[-1])}
            if validation_X is not None:
                v = self.reconstruct(params, validation_X)
                rec["val_mse"] = float(torch.mean((v - validation_X) ** 2))
            self.history.append(rec)
            if verbose and (ep % 10 == 0 or ep == epochs - 1):
                logger.info(f"epoch {ep}: train mse {rec['train_mse']:.5f}"
                            + (f" val mse {rec['val_mse']:.5f}" if "val_mse" in rec else ""))
        return params

    # -- persistence -----------------------------------------------------
    def save(self, params: AENet, model_path: str) -> None:
        """``<model_path>/autoencoders_latentFeatures/model.npz``: n_inputs,
        n_bottleneck and the JAX tree flattened as ``<layer>.w``,
        ``<layer>.b``, ``<layer>.bn.<key>``."""
        d = os.path.join(model_path, "autoencoders_latentFeatures")
        os.makedirs(d, exist_ok=True)
        flat = {}
        for lname, layer in params_to_jax(params.state_dict()).items():
            for k, v in layer.items():
                if k == "bn":
                    for bk, bv in v.items():
                        flat[f"{lname}.bn.{bk}"] = bv
                else:
                    flat[f"{lname}.{k}"] = v
        np.savez(os.path.join(d, "model.npz"), n_inputs=self.n_inputs,
                 n_bottleneck=self.n_bottleneck, **flat)

    @staticmethod
    def load(model_path: str, device=None) -> Tuple["AutoEncoder", AENet]:
        blob = np.load(os.path.join(model_path, "autoencoders_latentFeatures", "model.npz"))
        ae = AutoEncoder(int(blob["n_inputs"]), int(blob["n_bottleneck"]))
        tree: Dict = {}
        for key in blob.files:
            if key in ("n_inputs", "n_bottleneck"):
                continue
            parts = key.split(".")
            d = tree
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = blob[key]
        return ae, ae.net_from_state(params_from_jax(tree), device)
