"""FCN-8s trainer: Adam, train and eval steps, streaming IoU, CSV metric
logs, step checkpoints (port of ``semantic_depth_tpu/train/trainer.py``).

Hyperparameters are the reference's (fcn8s/fcn.py:238-535, thesis Table 5):
Adam lr 1e-5, batch 1, keep_prob 0.5, decoder init truncated normal 0.01,
decoder L2 1e-3. ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is
``optax.adam(lr)``: both add eps outside the square root.

A train step keeps the JAX step's order: loss and gradients with dropout on,
the Adam update, then a clean forward on the updated parameters, which
gives the confusion matrix.

Checkpoints are ``torch.save`` files of parameters, Adam state and step
under ``<dir>/step_<n>``; ``save_msgpack`` writes the flax weight layout
that both packages' CLIs read. The JAX trainer also draws its metric curves
as PNGs where matplotlib imports; this port writes the CSVs only.

``mesh``: a (dp, tp) ``DeviceMesh`` (``parallel.make_mesh``), one process
per mesh position. The train step runs sharded (``parallel/train_step.py``):
batches split over 'dp', fc6 / fc7 split over 'tp'. Each train batch must
divide by dp (``train_batch`` raises otherwise; ``fit`` drops the ragged
final batch); the eval path runs the whole batch on every rank. Weight
files and checkpoints hold the gathered, full parameters and Adam state,
written by rank 0, so a sharded run resumes on one device and the other way
round.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import TrainConfig
from ..models import FCN8s
from ..models import weights as weights_lib
from ..models.fcn8s import decoder_l2_loss
from ..models.from_flax import flax_tree, load_flax, state_dict_from_flax
from ..parallel import train_step as sharded
from ..parallel.mesh import axis_size
from ..runtime import resolve_device, set_full_fp32
from .data import SegmentationDataset
from .metrics import confusion_matrix, mean_iou_from_cm


def softmax_xent(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over all pixels (fcn.py:248-249)."""
    return -torch.mean(torch.sum(labels_onehot * F.log_softmax(logits, dim=-1), dim=-1))


class AdamTrainer:
    """What both trainers share: a module on one device, its Adam, a step
    counter, and their persistence. Runs on the card unless ``device="cpu"``;
    float32 stays full precision (no TF32). Under a ``mesh`` the files are
    written by rank 0 alone, and every rank must call the methods that
    write them."""

    def __init__(self, model: torch.nn.Module, learning_rate: float,
                 init_params: Optional[Mapping[str, Any]] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        set_full_fp32()
        self.learning_rate = learning_rate
        self.mesh = mesh
        self.model = model.to(self.device)
        if init_params is not None:
            load_flax(self.model, init_params)
        self._reset_optimizer()

    def _reset_optimizer(self, step: int = 0) -> None:
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.step = step

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _update(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss`` and one Adam step. The gradients stay on the
        parameters' ``.grad`` until the next step. Under a mesh the
        parameters are replicated, and the step takes the mean gradient
        over every rank."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            sharded.average_gradients(list(self.model.parameters()), None, self.mesh.size())
        self.optimizer.step()
        self.step += 1

    def _writes(self) -> bool:
        """Whether this process writes the files: the only one, or rank 0."""
        return self.mesh is None or dist.get_rank() == 0

    def _done_writing(self) -> None:
        """Under a mesh, every rank waits here until rank 0 has written."""
        if self.mesh is not None:
            dist.barrier()

    # the full parameters and Adam state, and back; a sharded trainer
    # gathers and cuts them
    def _full_params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def _full_opt_state(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def _load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state)

    def _local_opt_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return state

    def set_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters with a flax-layout tree (warm start,
        restore), resetting the optimizer state and the step counter."""
        self._load_params(state_dict_from_flax(params))
        self._reset_optimizer()

    def params_tree(self) -> Dict[str, Any]:
        """The full parameters as a flax-layout tree of float32 numpy arrays
        (under a mesh gathered on every rank)."""
        return flax_tree(self._full_params().items())

    def save_msgpack(self, path: str) -> str:
        """The parameters as the JAX package's ``.msgpack`` weight file."""
        tree = self.params_tree()
        if self._writes():
            weights_lib.save_params(tree, path)
        self._done_writing()
        return path

    def save_checkpoint(self, ckpt_dir: str) -> None:
        """Parameters, Adam state and step under ``<ckpt_dir>/step_<n>``: a
        resumed run steps like an uninterrupted one."""
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{self.step}"))
        state = {"params": self._full_params(), "opt_state": self._full_opt_state(),
                 "step": self.step}
        if self._writes():
            os.makedirs(path, exist_ok=True)
            torch.save(state, os.path.join(path, "state.pt"))
        self._done_writing()

    def restore_checkpoint(self, ckpt_dir: str, step: int) -> None:
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}", "state.pt"))
        state = torch.load(path, map_location=self.device, weights_only=True)
        self._load_params(state["params"])
        self._reset_optimizer(int(state["step"]))
        self.optimizer.load_state_dict(self._local_opt_state(state["opt_state"]))


class FCNTrainer(AdamTrainer):
    """``seed`` draws the init (when neither ``model`` nor ``init_params``
    is given) and the dropout masks, each from its own generator. ``mesh``:
    see the module's docstring; construction with any batch size works (test
    mode trains nothing)."""

    def __init__(
        self,
        config: TrainConfig,
        model: Optional[FCN8s] = None,
        init_params: Optional[Mapping[str, Any]] = None,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        self.config = config
        if model is None:
            model = FCN8s(num_classes=config.num_classes, dropout_keep_prob=config.dropout,
                          generator=torch.Generator().manual_seed(seed))
        if mesh is not None:  # this rank's blocks, cut before they reach the card
            model = sharded.shard_fcn_params(mesh, model if init_params is None
                                             else load_flax(model, init_params))
            init_params = None
        super().__init__(model, config.learning_rate, init_params, device, mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _reset_optimizer(self, step: int = 0) -> None:
        super()._reset_optimizer(step)
        if self.mesh is not None:
            self._sharded_step = sharded.make_sharded_train_step(
                self.mesh, self.model, self.optimizer, self.config.num_classes,
                self.config.l2_scale)

    def _full_params(self) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return super()._full_params()
        return sharded.gather_state_dict(self.mesh, self.model.state_dict())

    def _full_opt_state(self) -> Dict[str, Any]:
        if self.mesh is None:
            return super()._full_opt_state()
        return sharded.gather_adam_state(self.mesh, self.model, self.optimizer.state_dict())

    def _load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        if self.mesh is not None:
            state = sharded.shard_state_dict(self.mesh, state)
        super()._load_params(state)

    def _local_opt_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        if self.mesh is None:
            return state
        return sharded.shard_adam_state(self.mesh, self.model, state)

    def _dp(self) -> int:
        return axis_size(self.mesh, "dp")

    def _tp(self, batch: int):
        """The eval forward's ``tp``: the whole batch on every rank."""
        return None if self.mesh is None else sharded.tensor_shard(self.mesh, batch, whole=True)

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return softmax_xent(logits, labels) + decoder_l2_loss(self.model, self.config.l2_scale)

    def _cm(self, labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        return confusion_matrix(labels.argmax(-1), logits.argmax(-1), self.config.num_classes)

    def train_batch(self, images, labels) -> Dict[str, Any]:
        if self.mesh is not None:
            if images.shape[0] % self._dp():
                raise ValueError(
                    f"batch of {images.shape[0]} cannot be split over dp={self._dp()}; feed "
                    "batches divisible by dp (fit() drops the ragged final batch in mesh mode)")
            loss, cm = self._sharded_step(self._tensor(images), self._tensor(labels),
                                          self.generator)
            self.step += 1
            return {"loss": loss.item(), "iou": mean_iou_from_cm(cm).item(),
                    "cm": cm.cpu().numpy()}
        images, labels = self._tensor(images), self._tensor(labels)
        loss = self._loss(self.model(images, train=True, generator=self.generator), labels)
        self._update(loss)
        # IoU on the clean (no-dropout) forward of the UPDATED parameters, as
        # the reference's second feed_dict_train_iou pass (fcn.py:298-308)
        with torch.no_grad():
            cm = self._cm(labels, self.model(images))
        return {"loss": loss.item(), "iou": mean_iou_from_cm(cm).item(), "cm": cm.cpu().numpy()}

    def eval_batch(self, images, labels) -> Dict[str, Any]:
        images, labels = self._tensor(images), self._tensor(labels)
        with torch.no_grad():
            logits = self.model(images, tp=self._tp(images.shape[0]))
            loss = self._loss(logits, labels)
            cm = self._cm(labels, logits)
            probs = torch.softmax(logits, dim=-1)
        return {"loss": float(loss), "cm": cm.cpu().numpy(), "probs": probs.cpu().numpy()}

    def fit(
        self,
        dataset: SegmentationDataset,
        log_dir: Optional[str] = None,
        model_name: str = "model",
        verbose: bool = True,
    ) -> Dict[str, list]:
        """Epoch loop with per-epoch train/val loss and IoU (train_nn,
        fcn.py:260-378)."""
        cfg = self.config
        try:  # progress bars like the reference's tqdm loops (fcn.py:285,339)
            from tqdm import tqdm
        except ImportError:  # pragma: no cover
            tqdm = lambda it, **kw: it  # noqa: E731
        history = {"train_loss": [], "train_iou": [], "val_loss": [], "val_iou": []}
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.time()
            losses, cms = [], []
            n_train = -(-dataset.num_images("train") // cfg.batch_size)
            dropped_ragged = False
            for images, labels in tqdm(
                dataset.batches(cfg.batch_size, mode="train"),
                desc=f"Epoch {epoch}: Train Batch", total=n_train, disable=not verbose,
            ):
                if self.mesh is not None and images.shape[0] % self._dp():
                    # the short final batch cannot split over dp: dropped
                    # (drop-remainder semantics of data-parallel training)
                    dropped_ragged = True
                    continue
                m = self.train_batch(images, labels)
                losses.append(m["loss"])
                cms.append(m["cm"])
            if dropped_ragged and verbose and epoch == 1:
                print(
                    "mesh mode: dropping the ragged final batch each epoch "
                    f"(dataset size not a multiple of batch_size={cfg.batch_size})"
                )
            train_loss = float(np.mean(losses)) if losses else float("nan")
            train_iou = _iou(cms)

            vlosses, vcms = [], []
            for images, labels in dataset.batches(cfg.batch_size, mode="val"):
                m = self.eval_batch(images, labels)
                vlosses.append(m["loss"])
                vcms.append(m["cm"])
            val_loss = float(np.mean(vlosses)) if vlosses else float("nan")
            val_iou = _iou(vcms)

            history["train_loss"].append(train_loss)
            history["train_iou"].append(train_iou)
            history["val_loss"].append(val_loss)
            history["val_iou"].append(val_iou)
            if verbose:
                print(
                    f"Epoch {epoch}/{cfg.epochs}: train loss {train_loss:.4f} "
                    f"iou {train_iou:.4f} | val loss {val_loss:.4f} iou {val_iou:.4f} "
                    f"({time.time() - t0:.1f}s)"
                )
        if log_dir:
            epochs = list(range(1, cfg.epochs + 1))
            write_metric_logs(log_dir, model_name, "loss", history["train_loss"],
                              history["val_loss"], epochs)
            write_metric_logs(log_dir, model_name, "iou", history["train_iou"],
                              history["val_iou"], epochs)
        return history

    def evaluate_test(self, dataset: SegmentationDataset) -> Dict[str, Any]:
        """Test-set IoU with the running value after each image, as the
        reference logs it (inference, fcn.py:384-492)."""
        per_image = []
        running = np.zeros((self.config.num_classes,) * 2, np.float32)
        for images, labels in dataset.batches(1, mode="test"):
            running = running + self.eval_batch(images, labels)["cm"]
            per_image.append(float(mean_iou_from_cm(torch.from_numpy(running))))
        return {"per_image_iou": per_image, "mean_iou": per_image[-1] if per_image else 0.0}


def _iou(cms) -> float:
    return float(mean_iou_from_cm(torch.from_numpy(np.sum(cms, axis=0)))) if cms else 0.0


def write_metric_logs(log_dir, model_name, metric_type, train_vals, val_vals, epochs):
    """The per-epoch CSV under log/<model>/<metric>/ (fcn.py:497-535), byte
    for byte the JAX trainer's."""
    metric_path = os.path.join(log_dir, model_name, metric_type)
    os.makedirs(metric_path, exist_ok=True)
    stamp = time.strftime("%Y_%m_%d %H-%M")
    csv_path = os.path.join(metric_path, f"{metric_type}_vs_epochs_{stamp}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", quotechar="|", quoting=csv.QUOTE_MINIMAL)
        w.writerow(["Epoch", f"TRAIN_{metric_type}", f"VAL_{metric_type}"])
        w.writerows(zip(epochs, train_vals, val_vals))
    return csv_path
