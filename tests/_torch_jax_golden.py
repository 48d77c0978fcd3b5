"""The JAX package's answers at full v0 width and float32, computed on the
CPU, for the port to be held to: ``tests/golden/torch_port_jax_v0.json``.

    python tests/_torch_jax_golden.py [--out PATH]

It rebuilds the file from seeds (a few minutes on 8 cores, about 8 GB of
memory); a rerun on the same machine writes the same bytes
(``tests/test_torch_port_golden.py``'s ``slow`` test checks that). The
port's side, ``chip_smoke.py`` phase 8 on a card and the CPU tests of
``tests/test_torch_port_golden.py``, reads the file as JSON only and
rebuilds every input itself, without JAX.

Inputs, from ``RECIPE``'s seed alone:
- the gene vocabulary (``synthetic.make_gene_names``), the essentials
  (``synthetic.write_essential_genes_csv``) and a 4,641,652 bp GenBank
  (``synthetic.write_genbank``), the JAX package's ``data/synthetic.py``;
- the v0 checkpoint, 55,039 genes, hidden 1,024, latent 64, float32:
  ``models/vae.py::init(cfg, key(seed))``;
- a 6,583 x 55,039 presence/absence matrix made in memory with the gene
  model of the port's ``synthetic.write_presence_absence_fast`` (core
  genes at 0.97, accessory genes at a rate drawn in [0.05, 0.9]; the same
  ``RandomState`` stream, rebuilt here without importing the port), split
  70/20/10 by ``data/split.py::three_way_split``.
Their SHA-256 digests come first in the file, so that a machine whose
numpy draws another stream reports "inputs differ".

Answers:
- ``pipeline``: ``sample_and_minimize`` of 2,048 genomes at seed 0 in
  chunks of 512, default and focused mode: one digest per FASTA record
  (the first 16 hex digits of the SHA-256 of its two lines), and, per
  genome, the genes whose float32 logit lies within ``near_zero`` of 0
  with the reference's bit there (``g + 1`` for a 1, ``-(g + 1)`` for a
  0). These are the only bits a correct float32 decode may decide
  otherwise: a card sums in another order, which moves a logit by about
  1e-7.
- ``sample``: ``Sampler.sample_packed`` (``--mode sample --save-dtype
  packed``) of the default latents: one digest per packed row.
- ``training``: ``create_trainer("v0", ...)`` at batch 2,048 for 2 epochs
  at float32 on the TPU branch of the trainer (the 8-row block shuffle and
  the fused clip + Adam, taken by setting ``_mesh_platform`` to ``"tpu"``;
  on the CPU the Pallas gather runs its jnp reference): per epoch every
  loss component (train, validation), the step counter, the rng key data,
  the early-stopping state, and for each leaf of the parameters, the
  BatchNorm statistics and the Adam moments its element count, sum, sum
  of squares and largest magnitude, and the sum and sum of squares of its
  change from the initial state; then the test set's F1 and accuracy from
  ``eval/metrics.py``.
- ``training.first_grad``: per parameter leaf the element count, sum,
  sum of squares and projection on a fixed normal vector
  (``projection``) of the loss's gradient at the initial state, on the
  first 2,048 training rows with the eps of ``key(seed + 2)`` at epoch 0:
  one step, before Adam's update can amplify anything.
- ``training.relu_near_zero``: per hidden layer of that forward (encoder
  0-2, decoder 0-2), the activations whose ReLU input lies within
  ``relu_near_zero`` of 0, with the reference's side (``i + 1`` above 0,
  ``-(i + 1)`` not, i the flat index into the (2,048, 1,024) layer): the
  only ReLU decisions that a correct float32 forward may take otherwise,
  and each one moves the gradient by about 1e-3 of its norm.
- ``training.reorders``: the same run (epochs, test metrics), recorded
  the same way, with its float32 sums reordered, nine times: the genes
  in three other orders (sums over genes), the hidden units of every
  hidden layer and the latent units in three other orders (sums over
  them), and the rows of every 8-row group in three other orders, each
  row keeping its eps (sums over the batch). Each is equal to the run in
  exact arithmetic and differs only in how its sums round. Full-width v0
  is ill-conditioned: a ReLU input within rounding of 0 may fall on
  either side, and Adam's first step moves every value by lr times the
  sign of its gradient, so a gradient within rounding of 0 (v0 has no L1
  term) takes a step of either sign; the KL term follows the latent
  layers that carry them. These runs show how far the JAX package moves
  from itself under rounding alone; the port's check holds each quantity
  to ``_assert_same_run``'s tolerance (tests/test_torch_train_trainer.py)
  or to three times their spread, whichever is wider.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

GOLDEN = REPO / "tests" / "golden" / "torch_port_jax_v0.json"
RECIPE = {
    "seed": 0, "genes": 55_039, "hidden": 1_024, "latent": 64,
    "essentials": 300, "genome_length": 4_641_652, "genomes": 6_583,
    "num_samples": 2_048, "chunk": 512, "n_probes": 100, "noise_level": 0.1,
    "batch": 2_048, "epochs": 2, "compute_dtype": "float32",
    "near_zero": 1e-5, "digest_hex": 16, "reorders": 3, "grad_key": 2,
    "relu_near_zero": 1e-4, "projection_len": 1 << 20,
}


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[: RECIPE["digest_hex"]]


def leaves_digest(flat: dict) -> str:
    """SHA-256 of the leaves' float32 bytes in the order of their sorted
    names."""
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k], np.float32).tobytes())
    return h.hexdigest()


def record_digests(path: str) -> list[str]:
    """The digest of each record of a FASTA the pipeline wrote, after its
    three '#' lines."""
    out = []
    with open(path, "rb") as f:
        for _ in range(3):
            assert f.readline().startswith(b"# ")
        while True:
            head = f.readline()
            if not head:
                return out
            out.append(digest(head + f.readline()))


def presence_absence_matrix(n_samples: int, n_genes: int, seed: int,
                            chunk_rows: int = 2048) -> np.ndarray:
    rng = np.random.RandomState(seed)
    core = rng.rand(n_genes) < 0.3
    p = np.where(core, 0.97, rng.uniform(0.05, 0.9, size=n_genes))
    rng.randint(1, 20, size=n_samples)  # the CSV's lineage row
    out = np.empty((n_samples, n_genes), np.uint8)
    for lo in range(0, n_genes, chunk_rows):
        hi = min(lo + chunk_rows, n_genes)
        out[:, lo:hi] = (rng.rand(hi - lo, n_samples) < p[lo:hi, None]).T
    return out


def leaf_stats(flat: dict, init: dict) -> dict:
    """Per leaf: n, sum, sum of squares, largest magnitude; and for a leaf
    of ``init`` the sum and sum of squares of its change from it."""
    out = {}
    for k in sorted(flat):
        a = np.asarray(flat[k], np.float64)
        s = {"n": int(a.size), "sum": float(a.sum()),
             "sumsq": float(np.square(a).sum()),
             "max_abs": float(np.abs(a).max())}
        if k in init:
            u = a - np.asarray(init[k], np.float64)
            s.update(upd_sum=float(u.sum()), upd_sumsq=float(np.square(u).sum()))
        out[k] = s
    return out


def inputs(root: Path) -> dict:
    from genome_minimizer_2_tpu.data import synthetic

    r, seed = RECIPE, RECIPE["seed"]
    genes = synthetic.make_gene_names(r["genes"], np.random.RandomState(seed))
    ess_csv = root / "essential_genes.csv"
    essentials = synthetic.write_essential_genes_csv(ess_csv, genes,
                                                     r["essentials"], seed)
    gb = root / "wild_type_sequence.gb"
    synthetic.write_genbank(gb, genes, r["genome_length"], seed)
    matrix = presence_absence_matrix(r["genomes"], r["genes"], seed)
    return {"genes": genes, "essentials": essentials, "genbank": str(gb),
            "matrix": matrix,
            "sha256": {
                "genes": hashlib.sha256("\n".join(genes).encode()).hexdigest(),
                "essentials": hashlib.sha256(ess_csv.read_bytes()).hexdigest(),
                "genbank": hashlib.sha256(gb.read_bytes()).hexdigest(),
                "matrix": hashlib.sha256(matrix.tobytes()).hexdigest()}}


def near_zero_bits(logits: np.ndarray, tau: float) -> list[list[int]]:
    out = []
    for row in logits:
        g = np.nonzero(np.abs(row) < tau)[0]
        out.append([int(i + 1) if row[i] > 0 else -int(i + 1) for i in g])
    return out


def projection(a: np.ndarray, r: np.ndarray) -> float:
    """<a folded onto len(r) places, r> in float64: place i sums the entries
    i, i + len(r), ... of a (a as it is if it is no longer than r)."""
    a = np.asarray(a, np.float64).ravel()
    if a.size > r.size:
        a = np.pad(a, (0, -a.size % r.size)).reshape(-1, r.size).sum(axis=0)
    return float(np.dot(a, r[: a.size]))


def first_gradient(trainer, state, train_x: np.ndarray) -> tuple[dict, list]:
    """``training.first_grad`` and ``training.relu_near_zero`` (module
    docstring): the gradient and the ReLU inputs of one jitted program (the
    inputs returned beside the loss, from vae.py's ``_bn_apply``)."""
    from genome_minimizer_2_tpu.models import vae
    from genome_minimizer_2_tpu.utils import checkpoint as ckpt

    r = RECIPE
    batch = trainer.prepare_data(train_x[: r["batch"]])
    key = jax.random.key(r["seed"] + r["grad_key"])
    original, pre = vae._bn_apply, []

    def bn_apply(x, params, stats, train):
        y, new = original(x, params, stats, train)
        pre.append(y)
        return y, new

    def loss(params):
        pre.clear()
        total = trainer._loss_fn(params, state.batch_stats, batch, key,
                                 jnp.int32(0), state.counter, True)[0]
        return total, list(pre)

    vae._bn_apply = bn_apply
    try:
        grad, pre_acts = jax.jit(jax.grad(loss, has_aux=True))(state.params)
    finally:
        vae._bn_apply = original
    flat = ckpt._flatten(grad, "params/")
    # the port draws the same float32 normals (core/prng.py)
    rv = np.asarray(jax.random.normal(jax.random.key(0), (r["projection_len"],),
                                      jnp.float32), np.float64)
    stats = {}
    for name in sorted(flat):
        a = np.asarray(flat[name])
        s = leaf_stats({name: a}, {})[name]
        stats[name] = {"n": s["n"], "sum": s["sum"], "sumsq": s["sumsq"],
                       "projection": projection(a, rv)}
    near = []
    for y in pre_acts:
        y = np.asarray(y).ravel()
        i = np.nonzero(np.abs(y) < r["relu_near_zero"])[0]
        near.append([int(j + 1) if y[j] > 0 else -int(j + 1) for j in i])
    return stats, near


def check_near_zero(packed: np.ndarray, logits: np.ndarray, tau: float) -> None:
    """The reference's own packed bits are its logits' signs wherever
    |logit| >= tau (its packed decode and its logits are two programs)."""
    from genome_minimizer_2_tpu.ops.pallas_kernels import unpack_bits

    bits = unpack_bits(packed, logits.shape[1]).astype(bool)
    bad = (bits != (logits > 0)) & (np.abs(logits) >= tau)
    assert not bad.any(), f"{int(bad.sum())} packed bits off their logit's sign"


def pipeline(inp: dict, root: Path) -> tuple[dict, dict]:
    from genome_minimizer_2_tpu.core.dtypes import resolve_policy
    from genome_minimizer_2_tpu.core.prng import draw_latents
    from genome_minimizer_2_tpu.genome.converter import load_essential_set
    from genome_minimizer_2_tpu.genome.minimizer import MinimizerEngine
    from genome_minimizer_2_tpu.models import vae
    from genome_minimizer_2_tpu.pipeline import sample_and_minimize
    from genome_minimizer_2_tpu.sample.sampler import Sampler
    from genome_minimizer_2_tpu.utils import checkpoint as ckpt

    r, seed = RECIPE, RECIPE["seed"]
    cfg = vae.VAEConfig(input_dim=r["genes"], hidden_dim=r["hidden"],
                        latent_dim=r["latent"],
                        policy=resolve_policy(r["compute_dtype"]))
    params, stats = vae.init(cfg, jax.random.key(seed))
    inp["sha256"]["checkpoint"] = leaves_digest(
        {**ckpt._flatten(params, "params/"), **ckpt._flatten(stats, "batch_stats/")})
    sampler = Sampler(cfg=cfg, params=params, batch_stats=stats)
    engine = MinimizerEngine.from_genbank(inp["genbank"])
    essential_set = load_essential_set(str(root / "essential_genes.csv"))
    logits_fn = jax.jit(lambda p, s, z: vae.decode_logits(cfg, p, s, z, train=False)[0])
    n, chunk, tau = r["num_samples"], r["chunk"], r["near_zero"]

    out, logits = {}, {}
    for mode in ("default", "focused"):
        fasta = str(root / f"{mode}.fasta")
        sample_and_minimize(sampler, engine, inp["genes"], essential_set, n,
                            fasta, key=jax.random.key(seed), chunk_size=chunk,
                            model_name="golden", sampling_mode=mode,
                            noise_level=r["noise_level"], n_probes=r["n_probes"])
        digests = record_digests(fasta)
        os.remove(fasta)
        # the pipeline's latents (pipeline.py, submit), decoded to logits
        key, anchor = jax.random.key(seed), None
        if mode == "focused":
            probe_key, key = jax.random.split(key)
            anchor = jnp.asarray(sampler.focused_anchor(probe_key, r["n_probes"]),
                                 jnp.float32)
        rows = []
        for lo in range(0, n, chunk):
            z = draw_latents(key, jnp.arange(lo, lo + chunk), r["latent"])
            if anchor is not None:
                z = anchor + jnp.float32(r["noise_level"]) * z
            rows.append(np.asarray(logits_fn(params, stats, z))[:, : r["genes"]])
        logits[mode] = np.concatenate(rows)
        out[mode] = {"records": len(digests), "digests": digests,
                     "near_zero": near_zero_bits(logits[mode], tau)}

    packed, _ = sampler.sample_packed(jax.random.key(seed), n)
    check_near_zero(packed, logits["default"], tau)
    sample = {"rows": int(packed.shape[0]), "row_bytes": int(packed.shape[1]),
              "digests": [digest(row.tobytes()) for row in packed]}
    return out, sample


GROUP = 8  # rows of a block of the block shuffle


class Reorder:
    """A reordering of a run's float32 sums, equal in exact arithmetic:
    ``kind`` "genes" (the data's columns and the weights that meet them),
    "hidden" (the units of the six hidden layers and of the latent layer)
    or "batch" (the rows of every 8-row group, the block shuffle's unit,
    which keeps each group a block; each row keeps its eps). The padding
    column stays last."""

    def __init__(self, kind: str, k: int):
        self.kind = kind
        rng = np.random.RandomState(RECIPE["seed"] + 1 + k)
        if kind == "genes":
            self.genes = rng.permutation(RECIPE["genes"])
        elif kind == "hidden":
            self.hidden = [rng.permutation(RECIPE["hidden"]) for _ in range(6)]
            self.latent = rng.permutation(RECIPE["latent"])
        else:
            self.rows = rng.permutation(GROUP)
            while (self.rows == np.arange(GROUP)).all():
                self.rows = rng.permutation(GROUP)

    def data(self, x: np.ndarray) -> np.ndarray:
        if self.kind == "genes":
            return x[:, self.genes]
        if self.kind == "batch":
            m = x.shape[0] // GROUP * GROUP
            x = x.copy()
            x[:m] = x[:m].reshape(-1, GROUP, x.shape[1])[:, self.rows].reshape(m, -1)
        return x

    def eps(self, eps):
        """The eps that the reordered rows and latent units meet."""
        if self.kind == "hidden":
            return eps[:, self.latent]
        if self.kind == "batch":
            m = eps.shape[0] // GROUP * GROUP
            head = eps[:m].reshape(-1, GROUP, eps.shape[1])[:, self.rows]
            return jnp.concatenate([head.reshape(m, -1), eps[m:]])
        return eps

    def state(self, state):
        """The initial train state in this order (the moments are 0)."""
        params, stats = state.params, state.batch_stats
        if self.kind == "genes":
            full = np.concatenate([self.genes, np.arange(
                len(self.genes), params["encoder"][0]["w"].shape[0])])
            first = dict(params["encoder"][0], w=params["encoder"][0]["w"][full])
            out = params["decoder"][3]
            out = dict(out, w=out["w"][:, full], b=out["b"][full])
            return state._replace(params={
                **params, "encoder": [first, *params["encoder"][1:]],
                "decoder": [*params["decoder"][:3], out]})
        if self.kind == "batch":
            return state

        def layer(p, s, into, out):
            p = dict(p, w=p["w"][into][:, out], b=p["b"][out])
            if "bn" in p:
                p["bn"] = {k: v[out] for k, v in p["bn"].items()}
                s = {k: v[out] for k, v in s.items()}
            return p, s

        enc, dec = self.hidden[:3], self.hidden[3:]
        ins = [np.arange(params["encoder"][0]["w"].shape[0]), *enc[:2]]
        e = [layer(params["encoder"][i], stats["encoder"][i], ins[i], enc[i])
             for i in range(3)]
        heads = {h: layer(params[h], None, enc[2], self.latent)[0]
                 for h in ("mean", "logvar")}
        ins = [self.latent, *dec]
        d = [layer(params["decoder"][i], stats["decoder"][i], ins[i], dec[i])
             for i in range(3)]
        out = params["decoder"][3]
        out = dict(out, w=out["w"][dec[2]])
        return state._replace(
            params={"encoder": [p for p, _ in e], **heads,
                    "decoder": [*(p for p, _ in d), out]},
            batch_stats={"encoder": [s for _, s in e],
                         "decoder": [s for _, s in d]})


def training(inp: dict, reorder: Reorder | None = None) -> dict:
    """The v0 run (module docstring); with ``reorder``, the same run with
    its sums in that order: equal in exact arithmetic, it differs only in
    how they round."""
    from genome_minimizer_2_tpu.data.split import three_way_split
    from genome_minimizer_2_tpu.eval import metrics as ME
    from genome_minimizer_2_tpu.models import vae
    from genome_minimizer_2_tpu.train.trainer import create_trainer
    from genome_minimizer_2_tpu.utils import checkpoint as ckpt
    from genome_minimizer_2_tpu.utils.config import get_preset_config

    r = RECIPE
    cfg = get_preset_config("v0")
    cfg.hidden_dim, cfg.latent_dim, cfg.batch_size = r["hidden"], r["latent"], r["batch"]
    cfg.compute_dtype, cfg.seed, cfg.n_epochs = r["compute_dtype"], r["seed"], r["epochs"]
    # the loss schedule takes n_epochs now; each call below then runs one
    # epoch of it and resumes (bit-exact), so each epoch's state is seen
    trainer = create_trainer("v0", cfg, r["genes"])
    trainer._mesh_platform = lambda: "tpu"  # the block shuffle, fused Adam
    sp = three_way_split(inp["matrix"].shape[0], cfg.test_size, cfg.val_ratio,
                         cfg.random_state)
    train_x, val_x, test_x = (inp["matrix"][idx].astype(np.float32) for idx in sp)
    state = trainer.init_state()
    if reorder is not None:
        train_x, val_x, test_x = map(reorder.data, (train_x, val_x, test_x))
        state = reorder.state(state)
    assert trainer._use_block_shuffle(train_x.shape[0])

    def flat(state) -> dict:
        out = {**ckpt._flatten(state.params, "params/"),
               **ckpt._flatten(state.batch_stats, "batch_stats/")}
        for k, v in ckpt._flatten(state.opt_state, "opt_state/").items():
            if "/.mu/" in k or "/.nu/" in k:
                out[k] = v
        return {k: np.array(v) for k, v in out.items()}

    init = {k: v for k, v in flat(state).items()
            if not k.startswith("opt_state/")}  # the moments start at 0
    grad = None
    if reorder is None:
        inp["sha256"]["train_init"] = leaves_digest(init)
        grad = first_gradient(trainer, state, train_x)
    # the eps of a reordered run meet its rows and latent units as the
    # run's eps meet them (vae.py's reparameterize, its eps reordered)
    original = vae.reparameterize
    if reorder is not None:
        def reparameterize(key, mean, logvar):
            std = jnp.exp(0.5 * logvar)
            eps = reorder.eps(jax.random.normal(key, mean.shape, mean.dtype))
            return mean + std * eps
        vae.reparameterize = reparameterize
    jax.clear_caches()
    try:
        epochs = []
        for e in range(r["epochs"]):
            cfg.n_epochs = e + 1
            trainer.train(train_x, val_x, state=state, start_epoch=e)
            state = trainer.final_state
            es = trainer.early_stopping
            epochs.append({
                "train_losses": {k: v[e] for k, v in trainer.train_losses.items()},
                "val_losses": {k: v[e] for k, v in trainer.val_losses.items()},
                "counter": int(state.counter),
                "rng": [int(x) for x in np.asarray(jax.random.key_data(state.rng))],
                "early_stopping": {"best_loss": float(es.best_loss),
                                   "epochs_no_improve": int(es.epochs_no_improve)},
                "leaves": leaf_stats(flat(state), init)})
        f1, acc, _, _ = ME.calculate_reconstruction_metrics(
            trainer.model_cfg, state.params, state.batch_stats, test_x,
            jax.random.key(cfg.seed + 1), batch_size=cfg.batch_size)
    finally:
        vae.reparameterize = original
        jax.clear_caches()
    out = {"epochs": epochs, "test": {"f1": float(f1), "accuracy": float(acc)}}
    if reorder is not None:
        return {"reorder": reorder.kind, **out}
    return {"rows": {"train": len(sp.train_idx), "val": len(sp.val_idx),
                     "test": len(sp.test_idx)},
            "learning_rate": cfg.learning_rate, "lambda_l1": cfg.lambda_l1,
            "first_grad": grad[0], "relu_near_zero": grad[1], **out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(GOLDEN))
    out = Path(parser.parse_args().out)
    with tempfile.TemporaryDirectory(prefix="gm2_golden_") as tmp:
        root = Path(tmp)
        inp = inputs(root)
        pipe, sample = pipeline(inp, root)
        train = training(inp)
        train["reorders"] = [training(inp, Reorder(kind, k))
                             for kind in ("genes", "hidden", "batch")
                             for k in range(RECIPE["reorders"])]
    golden = {"about": "JAX package answers for the port's full-width float32 "
                       "checks; written by tests/_torch_jax_golden.py",
              "recipe": RECIPE, "sha256": inp["sha256"],
              "pipeline": pipe, "sample": sample, "training": train}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(golden, separators=(",", ":"), sort_keys=True) + "\n")
    print(f"wrote {out} ({out.stat().st_size:,} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
