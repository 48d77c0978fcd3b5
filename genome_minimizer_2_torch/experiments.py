"""Integrated experiment runner: the port of the JAX package's
``experiments.py`` (:39-216), with the same stage sequence: prep data ->
build trainer -> display + save config -> train -> loss plot -> F1 /
accuracy metrics -> latent PCA -> summary panel, saving artifacts under
``models/{experiment}/figures`` and ``models/trained_models/{experiment}``.

Checkpoints carry the config and ``input_dim`` in the JAX package's format,
so the JAX package's ``load_checkpoint`` and the port's ``load_sampler``
both read them. It runs on the card (``cuda`` unless the caller asks for
the CPU), or on every rank of the process group as a grid of
``config.data_parallel`` x ``config.model_parallel`` ranks (JAX
``experiments.py:53-55``; the trainer forms it, ``train/trainer.py``),
where rank 0 alone writes the checkpoints (full leaves, gathered over the
model axis), the config report, the metrics summary and the figures.
Training runs under :func:`utils.profiling.trace` (``profile_dir`` or
``GM2_PROFILE_DIR``), and with ``max_restarts`` and ``checkpoint_every``
set it restarts from the newest checkpoint after a crash
(:func:`utils.elastic.train_with_restarts`).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .core.dtypes import resolve_device
from .data import dataset as D
from .data import split as S
from .eval import metrics as ME
from .eval import visualise as V
from .models.vae import param_count
from .ops import prng
from .parallel.distributed import rank_and_world
from .sample.sampler import Sampler
from .train import trainer as T
from .utils import checkpoint as CKPT
from .utils import directories
from .utils.config import ExperimentConfig, config_report
from .utils.elastic import train_with_restarts
from .utils.profiling import trace

logger = logging.getLogger(__name__)


class IntegratedExperimentRunner:
    """Experiment runner (reference parity: experiments.py:117-444)."""

    def __init__(self, config: ExperimentConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        # rank 0 alone writes the report, summaries and figures
        self.writer = rank_and_world()[0] == 0
        self.logger = logging.getLogger(f"{__name__}.{config.experiment_name}")
        root = directories.project_root()
        self.figure_dir = os.path.join(root, "models", config.experiment_name, "figures")
        self.model_dir = os.path.join(root, "models", "trained_models",
                                      config.experiment_name)
        os.makedirs(self.figure_dir, exist_ok=True)
        os.makedirs(self.model_dir, exist_ok=True)
        self.logger.info("Created directories: %s, %s", self.figure_dir, self.model_dir)
        self.results: Dict = {}
        self.input_dim = None
        self.trainer: T.VAETrainer | None = None
        self._splits = None
        self._matrix = None

    # -- stages -----------------------------------------------------------

    def display_config(self):
        """Print + save the formatted config report (experiments.py:147-193)."""
        text = config_report(self.config)
        print(text)
        if not self.writer:
            return
        config_file = Path(self.figure_dir) / f"{self.config.experiment_name}_config.txt"
        config_file.write_text(text)
        self.logger.info("Configuration saved to: %s", config_file)

    def prep_data(self):
        """Load the dataset and build the 70/20/10 split (experiments.py:195-252)."""
        self.logger.info("Loading the dataset...")
        matrix = D.load_matrix()
        self._matrix = matrix
        self.input_dim = matrix.n_genes
        self.logger.info("Dataset: %d samples x %d genes", matrix.n_samples,
                         matrix.n_genes)
        sp = S.three_way_split(matrix.n_samples, self.config.test_size,
                               self.config.val_ratio, self.config.random_state)
        self._splits = sp
        self.logger.info("Data splits - Train: %d, Val: %d, Test: %d",
                         len(sp.train_idx), len(sp.val_idx), len(sp.test_idx))

    def setup_model_and_training(self):
        self.logger.info("Model architecture: %d -> %d -> %d", self.input_dim,
                         self.config.hidden_dim, self.config.latent_dim)
        self.trainer = T.create_trainer(self.config.trainer_version, self.config,
                                        self.input_dim, device=self.device)
        self.logger.info("Model parameters - Total: %s",
                         f"{param_count(self.trainer.model_cfg):,}")

    def train_model(self):
        self.logger.info("Starting training with %s configuration...",
                         self.config.trainer_version)
        m, sp = self._matrix, self._splits
        train_x = m.data[sp.train_idx]
        val_x = m.data[sp.val_idx]
        state, start_epoch = None, 0
        if self.config.resume_from:
            state, start_epoch = self.trainer.resume_from(self.config.resume_from)
            self.logger.info("Resumed from %s at epoch %d",
                             self.config.resume_from, start_epoch)
        ckpt_path = os.path.join(self.model_dir, "train_state_{epoch}.npz") \
            if self.config.checkpoint_every else None
        max_restarts = getattr(self.config, "max_restarts", 0)
        with trace(self.config.profile_dir or None):
            if max_restarts and ckpt_path:
                tl, vl, epochs, restarts = train_with_restarts(
                    self.trainer, train_x, val_x, checkpoint_path=ckpt_path,
                    checkpoint_every=self.config.checkpoint_every,
                    max_restarts=max_restarts)
                self.results["restarts"] = restarts
                if restarts:
                    self.logger.warning("Training auto-restarted %d time(s)",
                                        restarts)
            else:
                tl, vl, epochs = self.trainer.train(
                    train_x, val_x, state=state, start_epoch=start_epoch,
                    checkpoint_path=ckpt_path,
                    checkpoint_every=self.config.checkpoint_every)
        self.results["train_loss_vals"] = tl
        self.results["val_loss_vals"] = vl
        self.results["epochs_trained"] = epochs
        self.results["epoch_seconds"] = list(self.trainer.epoch_seconds)
        self.results["n_train"] = len(sp.train_idx)
        self.logger.info("Training completed after %d epochs", epochs)
        self.logger.info("Final train loss: %.4f", tl[-1])
        self.logger.info("Final validation loss: %.4f", vl[-1])
        if self.config.save_model:
            st = self.trainer.final_state
            model_path = os.path.join(
                self.model_dir, f"saved_VAE_{self.config.trainer_version}.npz")
            CKPT.save_checkpoint(model_path, st.model.full_params(),
                                 st.batch_stats, self.config,
                                 extra={"input_dim": self.input_dim,
                                        "epochs_trained": epochs})
            self.results["model_path"] = model_path
            self.logger.info("Model saved to %s", model_path)

    def generate_comparison_plots(self):
        if not self.config.generate_plots or not self.writer:
            self.logger.info("Skipping plot generation (disabled in config)")
            return
        epochs = np.linspace(1, self.results["epochs_trained"],
                             num=self.results["epochs_trained"])
        name = os.path.join(self.figure_dir,
                            f"{self.config.trainer_version}_train_val_loss.pdf")
        V.plot_loss_vs_epochs_graph(epochs, self.results["train_loss_vals"],
                                    self.results["val_loss_vals"], name)
        self.logger.info("Loss comparison plot saved to %s", name)

    def calculate_metrics(self):
        if not self.config.calculate_metrics:
            self.logger.info("Skipping metrics calculation (disabled in config)")
            return
        model = self.trainer.final_state.model
        test_x = self._matrix.data[self._splits.test_idx]
        overall_f1, overall_acc, f1s, accs = ME.calculate_reconstruction_metrics(
            model, test_x, prng.key(self.config.seed + 1, self.device),
            batch_size=self.config.batch_size)
        self.results.update(
            f1_overall=overall_f1, accuracy_overall=overall_acc,
            f1_scores_per_sample=f1s, accuracy_scores_per_sample=accs)
        self.logger.info("Overall F1 Score: %.4f", overall_f1)
        self.logger.info("Overall Accuracy: %.4f", overall_acc)
        if not self.writer:
            return
        ME.print_metric_summary(self.config, overall_f1, overall_acc, f1s, accs,
                                self.figure_dir)
        if self.config.generate_plots:
            V.generate_metric_histograms(f1s, accs, self.config, self.figure_dir)

    def explore_latent_space(self):
        if not self.config.explore_latent_space:
            self.logger.info("Skipping latent space exploration (disabled in config)")
            return
        test_x = self._matrix.data[self._splits.test_idx]
        test_phylo = self._matrix.phylogroups[self._splits.test_idx]
        sampler = Sampler(model=self.trainer.final_state.model)
        latents = sampler.encode_means(test_x, batch_size=self.config.batch_size)
        df_pca = V.plot_latent_space_pca(
            latents, test_phylo, self.config, self.figure_dir,
            show_plot=self.config.generate_plots and self.writer)
        self.results["pca_data"] = df_pca
        self.logger.info("Latent space PCA analysis completed")

    def generate_summary_plot(self):
        if (not self.config.generate_plots or not self.writer
                or "f1_scores_per_sample" not in self.results):
            self.logger.info("Skipping summary plot generation")
            return
        V.create_training_summary_plot(
            self.results["train_loss_vals"], self.results["val_loss_vals"],
            self.results["f1_scores_per_sample"],
            self.results["accuracy_scores_per_sample"],
            self.figure_dir, self.config.experiment_name)
        self.logger.info("Summary plot generated")

    # -- pipeline ---------------------------------------------------------

    def run_complete_experiment(self) -> Dict:
        self.logger.info("** START OF EXPERIMENT: %s **", self.config.experiment_name)
        self.prep_data()
        self.setup_model_and_training()
        self.display_config()
        self.train_model()
        self.generate_comparison_plots()
        self.calculate_metrics()
        self.explore_latent_space()
        self.generate_summary_plot()
        self.logger.info("** EXPERIMENT %s COMPLETED SUCCESSFULLY **",
                         self.config.experiment_name)
        return self.results
