"""The dp x tp FCN-8s training step (port of
``semantic_depth_tpu/parallel/train_step.py``).

The layout is the JAX package's, in torch's weight order:

* the batch and its labels: split over 'dp' along the batch;
* fc6 ``(4096, 512, 7, 7)``: output channels (dim 0) split over 'tp', its
  bias too, so fc6's ReLU and dropout stay local;
* fc7 ``(4096, 4096, 1, 1)``: input channels (dim 1) split over 'tp'; the
  ranks' partial outputs are summed over 'tp' and the bias, replicated, is
  added once after the sum (Megatron's column -> row pairing,
  ``models/tensor_parallel.py``);
* everything else replicated.

Each rank holds its blocks as the parameters of an ``FCN8s`` whose fc6 and
fc7 have the block's shapes (``shard_fcn_params``), and Adam's moments
mirror them. A step: the loss and its gradients on this rank's rows of the
batch, the gradients averaged over 'dp' (one ``comm.all_reduce_sum`` of
every gradient, divided by dp, so that the replicated decoder L2 counts
once), the local Adam step (elementwise, so a block updates alone), then
the clean forward that gives the confusion matrix; the loss and the
confusion matrix come back reduced over 'dp' (the mean loss, the summed
counts). ``comm.all_reduce_sum`` gives every rank the same bits, so the
replicated parameters and their Adam moments stay bit-identical on every
rank.

The dropout masks are the single-device step's: each rank draws the whole
batch's mask from the same-seeded generator and keeps its block
(``tensor_parallel.keep_mask``), so a sharded step can be held against the
single-device ``FCNTrainer`` with the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch

from ..models.fcn8s import decoder_l2_loss
from ..models.from_flax import flax_tree, state_dict_from_flax
from ..models.spatial import like
from ..train.metrics import confusion_matrix
from . import comm
from .mesh import axis_rank, axis_size

# the torch dim of each parameter that is split over 'tp'; the rest is replicated
SPLIT_DIMS = {"fc6.weight": 0, "fc6.bias": 0, "fc7.weight": 1}


class _CopyToTP(torch.autograd.Function):
    """fc6's input: the same on every tp rank forward; the ranks' partial
    gradients summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return like(comm.all_reduce_sum([g], ctx.group)[0], g), None


class _ReduceFromTP(torch.autograd.Function):
    """fc7's partial outputs summed over tp forward; the gradient of the sum
    is every rank's gradient, as it is, backward."""

    @staticmethod
    def forward(ctx, x, group):
        return like(comm.all_reduce_sum([x], group)[0], x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass(frozen=True)
class TensorShard:
    """The ``tp`` argument of ``FCN8s.forward``: this rank's place on the
    tp axis and its rows of the batch (``batch`` rows in all)."""

    group: Any
    rank: int
    size: int
    rows: slice
    batch: int

    def channels(self, n: int) -> slice:
        """This rank's block of ``n`` channels."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.group)


def tensor_shard(mesh, batch: int, whole: bool = False) -> TensorShard:
    """This rank's ``TensorShard`` for a batch of ``batch``: its dp rows of
    it, or all of them (``whole``, the eval path, which runs the whole batch
    on every rank)."""
    dp = 1 if whole else axis_size(mesh, "dp")
    if batch % dp:
        raise ValueError(f"batch of {batch} cannot be split over dp={dp}")
    per, i = batch // dp, 0 if whole else axis_rank(mesh, "dp")
    return TensorShard(mesh.get_group("tp"), axis_rank(mesh, "tp"), axis_size(mesh, "tp"),
                       slice(i * per, (i + 1) * per), batch)


def _block(mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` of parameter ``name``."""
    if name not in SPLIT_DIMS:
        return t
    dim, tp = SPLIT_DIMS[name], axis_size(mesh, "tp")
    if t.shape[dim] % tp:
        raise ValueError(f"{name}: {t.shape[dim]} channels cannot be split over tp={tp}")
    per = t.shape[dim] // tp
    return t.narrow(dim, axis_rank(mesh, "tp") * per, per).clone()


def shard_state_dict(mesh, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full FCN-8s state dict cut to this rank's blocks."""
    return {name: _block(mesh, name, t) for name, t in state.items()}


def _gathered(mesh, named) -> list:
    """The full tensors of ``(parameter name, this rank's tensor)`` pairs:
    the split ones put back together from every tp rank's block in one
    gather, the replicated ones as they are."""
    out = [t for _, t in named]
    split = [k for k, (name, _) in enumerate(named) if name in SPLIT_DIMS]
    if split and axis_size(mesh, "tp") > 1:
        dims = [SPLIT_DIMS[named[k][0]] for k in split]
        full = comm.all_gather_tensors([out[k].movedim(d, 0) for k, d in zip(split, dims)], 0,
                                       mesh.get_group("tp"))
        for k, d, t in zip(split, dims, full):
            out[k] = t.movedim(0, d)
    return out


def gather_state_dict(mesh, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the full state dict, the same on
    every rank."""
    return dict(zip(state, _gathered(mesh, list(state.items()))))


def shard_fcn_params(mesh, params, model=None) -> torch.nn.Module:
    """This rank's FCN-8s. ``params`` is a module holding the full
    parameters (its fc6 and fc7 hold this rank's blocks afterwards), or a
    flax-layout numpy tree, loaded into ``model`` (a full-shape ``FCN8s``,
    or one this function sharded before)."""
    if isinstance(params, torch.nn.Module):
        model, full = params, params.state_dict()
    else:
        full = state_dict_from_flax(params)
    local = shard_state_dict(mesh, full)
    for name in SPLIT_DIMS:
        layer, kind = name.split(".")
        p = getattr(getattr(model, layer), kind)
        if p.shape != local[name].shape:
            setattr(getattr(model, layer), kind,
                    torch.nn.Parameter(torch.empty(local[name].shape, dtype=p.dtype,
                                                   device=p.device)))
    model.fc6.out_channels = model.fc6.weight.shape[0]
    model.fc7.in_channels = model.fc7.weight.shape[1]
    model.load_state_dict(local)
    return model


def gather_fcn_params(mesh, model: torch.nn.Module) -> Dict[str, Any]:
    """The full parameters of a sharded FCN-8s as a flax-layout tree of
    float32 numpy arrays (what ``save_params`` writes), on every rank."""
    return flax_tree(gather_state_dict(mesh, model.state_dict()).items())


def _moments(model, opt_state: Mapping[str, Any]):
    """A copy of a torch Adam ``state_dict()["state"]`` over
    ``model.parameters()``, and (param index, parameter name, field) of each
    of its moments."""
    names = [name for name, _ in model.named_parameters()]
    state = {i: dict(s) for i, s in opt_state["state"].items()}
    return state, [(i, names[i], f) for i in sorted(state) for f in ("exp_avg", "exp_avg_sq")]


def gather_adam_state(mesh, model, opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """A torch Adam ``state_dict()`` over a sharded FCN-8s with every
    moment put back together: the single-device optimizer's state, on every
    rank."""
    state, moments = _moments(model, opt_state)
    full = _gathered(mesh, [(n, state[i][f]) for i, n, f in moments])
    for (i, _, f), t in zip(moments, full):
        state[i][f] = t
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_adam_state(mesh, model, opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``gather_adam_state``: a single-device Adam state cut
    to this rank's blocks."""
    state, moments = _moments(model, opt_state)
    for i, n, f in moments:
        state[i][f] = _block(mesh, n, state[i][f])
    return {"state": state, "param_groups": opt_state["param_groups"]}


def average_gradients(params, group, n: int) -> None:
    """Replace each parameter's gradient by its mean over the ``n`` ranks of
    ``group``: one ``comm.all_reduce_sum`` of every gradient (the same bits
    on every rank), then a true division by ``n``."""
    if n == 1:
        return
    grads = comm.all_reduce_sum([p.grad for p in params], group)
    for p, g in zip(params, grads):
        p.grad = torch.div(g, g.new_tensor(float(n)))


def make_sharded_train_step(mesh, model, optimizer, num_classes: int, l2_scale: float = 1e-3):
    """Returns ``step(images, labels, generator) -> (loss, cm)`` over the
    whole batch ``(B, H, W, 3)`` / ``(B, H, W, C)`` on this rank's device:
    one Adam step of this rank's ``model`` (``shard_fcn_params``) on its dp
    rows, the mean loss over 'dp' and the confusion matrix summed over 'dp'
    (float32 counts). ``generator`` draws the dropout masks; every rank
    passes one seeded alike.

    With tp > 1 each tp rank computes the replicated layers' gradients on
    its own, so they are the same bits only where the algorithms are
    deterministic: this sets cuDNN's deterministic algorithms (and turns
    its autotuner off) for the process."""
    from ..train.trainer import softmax_xent

    if axis_size(mesh, "tp") > 1:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dp_group, dp = mesh.get_group("dp"), axis_size(mesh, "dp")
    params = list(model.parameters())

    def step(images: torch.Tensor, labels: torch.Tensor, generator):
        tp = tensor_shard(mesh, images.shape[0])
        x, y = images[tp.rows], labels[tp.rows]
        loss = (softmax_xent(model(x, train=True, generator=generator, tp=tp), y)
                + decoder_l2_loss(model, l2_scale))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(params, dp_group, dp)
        optimizer.step()
        # IoU on the clean forward of the UPDATED parameters, as the
        # single-device step
        with torch.no_grad():
            cm = confusion_matrix(y.argmax(-1), model(x, tp=tp).argmax(-1), num_classes)
        loss, cm = comm.all_reduce_sum([loss.detach(), cm.to(torch.int64)], dp_group)
        return torch.div(loss, loss.new_tensor(float(dp))), cm.float()

    return step
