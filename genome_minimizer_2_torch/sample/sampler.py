"""Latent sampling of synthetic genomes: the port of the JAX package's
``sample/sampler.py`` (default and focused modes, packed masks).

Sampling decodes latents in fixed-size chunks (every partial chunk is padded
to the chunk size, as in the JAX package), thresholds on the device
(logits > 0 == sigmoid > 0.5) with the fused ``decode_threshold_pack``
kernel, and ships only packed bitmasks to the host.

JAX's asynchronous dispatch plus ``copy_to_host_async`` becomes, per chunk:
a copy into a pinned host buffer with ``non_blocking=True``, a CUDA event
recorded after the copy, and a drain that waits on that event only
(:class:`HostTransfer`). Everything is enqueued on PyTorch's current stream,
so the device decodes the chunks ahead while the host drains earlier ones.

On W > 1 data-parallel ranks (``Sampler(axis=...)``, sample mode's
``--data-parallel``) each chunk, padded to the chunk size, is decoded in
contiguous row shares, one per rank, and every rank receives the whole
chunk's packed rows in rank order (the JAX package's row-sharded decode,
``sampler.py:36-108``). A row's bits do not depend on which rank decoded it,
so the samples equal a one-process run's.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.dtypes import resolve_device, resolve_policy, round_up
from ..models import vae
from ..ops import kernels as K
from ..parallel.mesh import Axis
from ..utils.profiling import span
from . import host_counts as HC


class HostTransfer:
    """A device result on its way into pinned host memory. ``wait()``
    blocks on the copy's CUDA event (not on the whole device) and returns
    the host array; a CPU result is ready at once."""

    def __init__(self, dev: torch.Tensor):
        self._event = None
        if dev.device.type == "cpu":
            self._host = dev
            return
        self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        self._host.copy_(dev, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(dev.device))

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


@dataclasses.dataclass
class Sampler:
    """Wraps a VAE for batch decoding on its device; with ``axis``, the
    chunked decodes spread each chunk's rows over the ranks."""

    model: vae.VAE
    chunk_size: int = 1024
    axis: Axis | None = None

    def __post_init__(self):
        if self.axis is not None and self.chunk_size < self.axis.world:
            raise ValueError(f"chunk size {self.chunk_size} gives some of the "
                             f"{self.axis.world} ranks no rows")
        self.cfg = self.model.cfg
        self.device = next(self.model.parameters()).device
        cd = self.cfg.policy.compute_dtype
        # One copy of the output weight in the compute dtype, made here at
        # load: the kernel reads it every chunk (113 MB of bf16 at v0 width
        # instead of rounding 225 MB of float32 again per chunk). Under the
        # float32 policy it is the parameter itself.
        self._w_out = self.model.output.w.detach().to(cd).contiguous()
        self._b_out = self.model.output.b.detach().float().contiguous()

    # -- decode functions (device tensors in, device tensors out) ------------

    def _decode_packed(self, z: torch.Tensor) -> torch.Tensor:
        h = self.model.decode_hidden(z)
        return K.decode_threshold_pack(h, self._w_out, self._b_out,
                                       compute_dtype=self.cfg.policy.compute_dtype)

    def _decode_probs(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.model.decode_logits(z).float())

    def _rows(self, z, pad_to: int | None = None) -> torch.Tensor:
        """z as float32 on the device, zero rows appended up to ``pad_to``."""
        if isinstance(z, torch.Tensor):
            z = z.to(self.device, torch.float32)
        else:
            z = torch.from_numpy(np.array(z, dtype=np.float32)).to(self.device)
        pad = max(z.shape[0], pad_to or 0) - z.shape[0]
        return torch.nn.functional.pad(z, (0, 0, 0, pad)) if pad else z

    # -- helpers --------------------------------------------------------------

    def _chunks(self, n: int):
        for lo in range(0, n, self.chunk_size):
            yield lo, min(lo + self.chunk_size, n)

    def _decode_chunked(self, z, fn, trim: int | None = None, window: int = 4,
                        on_chunk=None) -> np.ndarray:
        """Run ``fn`` over chunks of ``z`` padded to the chunk size, keeping
        ``window`` chunks in flight, trimming padding rows and the feature
        axis to ``trim`` columns (default: input_dim). ``on_chunk(lo, hi,
        arr)`` sees each drained chunk in order. Ranges
        ``gm2/sample/{submit,wait,on_chunk}`` mark each chunk's stages, and
        ``gm2/sample/chunks`` the whole loop, the host's steps between
        stages included: a device gap that begins there is the sampler's."""
        n = z.shape[0]
        D = self.cfg.input_dim if trim is None else trim

        def submit(lo, hi):
            with span("gm2/sample/submit"):
                rows = self._rows(z[lo:hi], pad_to=self.chunk_size)
                if self.axis is None:
                    return lo, hi, HostTransfer(fn(rows))
                ax, C = self.axis, self.chunk_size
                a, e = ax.share(C)
                counts = [(q + 1) * C // ax.world - q * C // ax.world
                          for q in range(ax.world)]
                return lo, hi, HostTransfer(ax.all_gather_rows(fn(rows[a:e]),
                                                               counts))

        spans = iter(self._chunks(n))
        pending: deque = deque()
        outs = []
        with span("gm2/sample/chunks"):
            while True:
                while len(pending) < max(1, window):
                    chunk = next(spans, None)
                    if chunk is None:
                        break
                    pending.append(submit(*chunk))
                if not pending:
                    break
                lo, hi, transfer = pending.popleft()
                with span("gm2/sample/wait"):
                    arr = transfer.wait()[: hi - lo, :D]
                if on_chunk is not None:
                    with span("gm2/sample/on_chunk"):
                        on_chunk(lo, hi, arr)
                outs.append(arr)
            return np.concatenate(outs, axis=0)

    def decode_binary(self, z) -> np.ndarray:
        """Binary masks (N, input_dim) uint8 via the packed kernel path."""
        D = self.cfg.input_dim
        packed = self._decode_chunked(z, self._decode_packed, trim=(D + 7) // 8)
        return K.unpack_bits(packed, D)

    def decode_packed_device(self, z, pad_to: int | None = None) -> HostTransfer:
        """Enqueue the fused decode of ONE chunk and the copy of its packed
        bitmask to pinned host memory; return without blocking. Rows pad up
        to ``pad_to`` (the pipeline passes its chunk size); pass the true
        row count to :meth:`unpack_packed` to trim."""
        return HostTransfer(self._decode_packed(self._rows(z, pad_to)))

    def make_feature_decoder(self, col_idx: np.ndarray, ess: np.ndarray):
        """A chunk decoder that ships only the per-FEATURE keep bits (the
        JAX package's ``sampler.py:262-324``): feature f is kept iff its
        gene's bit is set or the gene is essential, which is all the
        minimizer reads (~0.5 KB a genome instead of ~6.9 KB at E. coli
        scale).

        The bits come from the same packed output of the decode kernel as
        the packed transfer, gathered on the device before any trim: the
        byte ``col_idx >> 3`` of each feature, shifted by ``col_idx & 7``;
        ``col_idx == -1`` (the gene is not a dataset column) reduces to the
        essential flag. They are padded to a multiple of 8 and packed with
        :func:`~genome_minimizer_2_torch.ops.kernels.pack_bits`. Returns
        ``decode(z, pad_to=None) -> HostTransfer`` with
        :meth:`decode_packed_device` semantics, yielding uint8 (rows,
        ceil(F/8)) KEEP bits, little bit order; unpack with
        ``unpack_bits(out, F)``."""
        col_idx = np.asarray(col_idx, np.int64)
        F = col_idx.size
        valid = col_idx >= 0
        if (col_idx >= self.cfg.input_dim).any():
            raise ValueError(f"col_idx beyond the model's {self.cfg.input_dim} "
                             "gene columns")
        dev = self.device
        byte_idx = torch.from_numpy(np.where(valid, col_idx >> 3, 0)).to(dev)
        shift = torch.from_numpy(np.where(valid, col_idx & 7, 0).astype(np.int32)
                                 ).to(dev)
        valid_t = torch.from_numpy(valid).to(dev)
        always = torch.from_numpy(np.asarray(ess, bool).astype(np.int32)).to(dev)
        pad = round_up(F, 8) - F

        def features(rows: torch.Tensor) -> torch.Tensor:
            packed = self._decode_packed(rows)
            bits = (packed.index_select(1, byte_idx).to(torch.int32) >> shift) & 1
            keep = torch.where(valid_t, bits, 0) | always
            return K.pack_bits(torch.nn.functional.pad(keep, (0, pad)))

        def decode(z, pad_to: int | None = None) -> HostTransfer:
            return HostTransfer(features(self._rows(z, pad_to)))

        return decode

    def unpack_packed(self, packed, rows: int | None = None) -> np.ndarray:
        """Trim padding rows/columns of a packed chunk (a host array or a
        :class:`HostTransfer`) and unpack to uint8 (rows, input_dim)."""
        D = self.cfg.input_dim
        if isinstance(packed, HostTransfer):
            packed = packed.wait()
        packed = np.asarray(packed)
        if rows is not None:
            packed = packed[:rows]
        return K.unpack_bits(packed[:, : (D + 7) // 8], D)

    # -- public API -----------------------------------------------------------

    def draw_latents(self, key: torch.Tensor, num_samples: int) -> np.ndarray:
        """z_i ~ N(0, I) per GLOBAL sample index, ``normal(fold_in(key,
        i))`` — the seed contract shared with the JAX package (range
        ``gm2/sample/draw``)."""
        with span("gm2/sample/draw"):
            key = key.to(self.device)
            idx = torch.arange(num_samples, dtype=torch.int64, device=self.device)
            return prng.draw_latents(key, idx, self.cfg.latent_dim).cpu().numpy()

    def sample(self, key: torch.Tensor, num_samples: int,
               return_probs: bool = False
               ) -> Tuple[np.ndarray, np.ndarray | None, np.ndarray]:
        """Default sampling: (binary uint8 (N, D), probs f32 | None, z)."""
        z = self.draw_latents(key, num_samples)
        binary = self.decode_binary(z)
        probs = self._decode_chunked(z, self._decode_probs) if return_probs else None
        return binary, probs, z

    def sample_packed(self, key: torch.Tensor, num_samples: int,
                      on_chunk=None) -> Tuple[np.ndarray, np.ndarray]:
        """Default sampling in PACKED form: (uint8 (N, ceil(D/8)), z). Bits
        at columns >= input_dim are always zero (zero padded weights)."""
        z = self.draw_latents(key, num_samples)
        D = self.cfg.input_dim
        packed = self._decode_chunked(z, self._decode_packed,
                                      trim=(D + 7) // 8, on_chunk=on_chunk)
        return packed, z

    def focused_anchor(self, probe_key: torch.Tensor,
                       n_probes: int = 100) -> np.ndarray:
        """The focused-mode probe stage: decode ``n_probes`` samples, dense
        probabilities included, and anchor on the min-gene probe via the
        reference's output-space distances. Returns z* as (1, latent)."""
        binary_temp, continuous_temp, z_temp = self.sample(
            probe_key, n_probes, return_probs=True)
        min_ones_index = int(np.argmin(binary_temp.sum(axis=1)))
        latent_distances = np.linalg.norm(
            continuous_temp - continuous_temp[min_ones_index], axis=1)
        closest_latent_index = int(np.argmin(latent_distances))
        return z_temp[closest_latent_index][None, :]

    def sample_focused(self, key: torch.Tensor, num_samples: int,
                       noise_level: float = 0.1, n_probes: int = 100,
                       return_probs: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray | None, np.ndarray]:
        """Focused sampling, dense: the probe stage of :meth:`focused_anchor`
        under the first half of ``split(key)``, then z* + noise_level *
        normal(fold_in(noise_key, i)). Returns (binary uint8 (N, D), probs
        f32 | None, z); probabilities of the final N only on request."""
        probe_key, noise_key = prng.split(key.to(self.device))
        z_of_interest = self.focused_anchor(probe_key, n_probes)
        z = z_of_interest + self.draw_latents(noise_key, num_samples) * noise_level
        binary = self.decode_binary(z)
        probs = self._decode_chunked(z, self._decode_probs) if return_probs else None
        return binary, probs, z

    def sample_focused_packed(self, key: torch.Tensor, num_samples: int,
                              noise_level: float = 0.1, n_probes: int = 100,
                              on_chunk=None) -> Tuple[np.ndarray, np.ndarray]:
        """Focused sampling in PACKED form: the probe stage of
        :meth:`focused_anchor` under the first half of ``split(key)``, then
        z* + noise_level * normal(fold_in(noise_key, i)) decoded packed."""
        probe_key, noise_key = prng.split(key.to(self.device))
        z_of_interest = self.focused_anchor(probe_key, n_probes)
        noise = self.draw_latents(noise_key, num_samples) * noise_level
        z = z_of_interest + noise
        D = self.cfg.input_dim
        packed = self._decode_chunked(z, self._decode_packed,
                                      trim=(D + 7) // 8, on_chunk=on_chunk)
        return packed, z

    def encode_means(self, x: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Latent means over a dataset in eval mode (get_latent_variables,
        extras.py:205-228; the JAX package's ``sampler.py:451``): float32
        (N, latent_dim). A model that holds a gene slice (tensor
        parallelism) encodes its columns; every rank of its model axis
        calls this with the same rows."""
        x = np.asarray(x, np.float32)
        outs = []
        for lo in range(0, x.shape[0], batch_size):
            rows = torch.from_numpy(x[lo: lo + batch_size]).to(self.device)
            mean, _ = self.model.encode(self.model.gene_columns(rows))
            outs.append(mean.cpu().numpy())
        return np.concatenate(outs, axis=0)


def load_sampler(checkpoint_path: str, input_dim: int | None = None,
                 device: str | torch.device = "cuda", chunk_size: int = 1024,
                 axis: Axis | None = None,
                 ) -> Tuple[Sampler, "ExperimentConfig"]:
    """Rebuild a Sampler on ``device`` from a checkpoint (the architecture
    comes from the stored config; ``compute_dtype='auto'`` resolves to
    bfloat16 on CUDA and float32 on the CPU); ``axis`` spreads its chunked
    decodes over the data-parallel ranks."""
    from ..utils import checkpoint as ckpt

    device = resolve_device(device)
    flat_p, flat_s, config, extra = ckpt.load_checkpoint(checkpoint_path)
    input_dim = input_dim or extra.get("input_dim")
    if input_dim is None:
        raise ValueError("input_dim not in checkpoint extras; pass explicitly")
    cfg = vae.VAEConfig(
        input_dim=int(input_dim),
        hidden_dim=config.hidden_dim,
        latent_dim=config.latent_dim,
        pad_features=config.pad_features,
        policy=resolve_policy(config.compute_dtype, device.type),
    )
    model = vae.params_from_flat(flat_p, flat_s, cfg, device=device)
    return Sampler(model=model, chunk_size=chunk_size, axis=axis), config


# ---------------------------------------------------------------------------
# Essential-gene counting and the samples CSV, dense (numpy, host side)
# ---------------------------------------------------------------------------

def _essential_segments(essential_gene_positions: Dict[str, List[int]],
                        width: int) -> Tuple[List[int], List[int]]:
    """Flattened positions < ``width`` of each essential gene that has any,
    and the start of each gene's segment among them."""
    pos_flat: List[int] = []
    seg_starts: List[int] = []
    for _, positions in essential_gene_positions.items():
        valid = [p for p in positions if p < width]
        if not valid:
            continue
        seg_starts.append(len(pos_flat))
        pos_flat.extend(valid)
    return pos_flat, seg_starts


def count_essential_genes(
    binary_generated_samples: np.ndarray,
    essential_gene_positions: Dict[str, List[int]],
) -> np.ndarray:
    """Per-sample count of present essential genes: a gene with several
    mapped positions counts once if ANY is set; positions >= the sample
    width are ignored. A gather + ``logical_or.reduceat`` over gene
    segments."""
    samples = np.asarray(binary_generated_samples)
    n, width = samples.shape
    pos_flat, seg_starts = _essential_segments(essential_gene_positions, width)
    if not pos_flat:
        return np.zeros(n, dtype=int)
    present = samples[:, np.asarray(pos_flat)] != 0
    per_gene_any = np.logical_or.reduceat(present, np.asarray(seg_starts), axis=1)
    return per_gene_any.sum(axis=1).astype(int)


def write_samples_to_dataframe(
    binary_generated_samples: np.ndarray,
    all_genes: Sequence[str],
    output_file: str,
) -> None:
    """Genes x samples CSV through pandas: first column 'Gene', then
    Sample_1 ... Sample_N."""
    import pandas as pd

    df = pd.DataFrame(np.asarray(binary_generated_samples), columns=list(all_genes))
    df.index = [f"Sample_{i + 1}" for i in range(df.shape[0])]
    df = df.transpose()
    df.columns = [f"Sample_{i + 1}" for i in range(df.shape[1])]
    df = df.reset_index()
    df = df.rename(columns={"index": "Gene"})
    df.to_csv(output_file, index=False)


# ---------------------------------------------------------------------------
# Packed-bitmask analytics and bounded-memory writers (numpy, host side)
# ---------------------------------------------------------------------------

def popcount_rows(packed: np.ndarray, chunk_rows: int = 8192) -> np.ndarray:
    """Per-row set-bit counts of a packed bitmask — genome sizes, without
    unpacking (pad bits beyond input_dim are zero by construction; range
    ``gm2/sample/count_genes``). One native pass over the rows by 64-bit
    word with the hardware popcount, on host threads by row count
    (``host_counts.py``); a view whose rows are not contiguous is copied.
    ``chunk_rows`` is accepted and unused: the pass holds no temporaries."""
    with span("gm2/sample/count_genes"):
        return HC.popcount_rows(packed, HC.threads_for(len(packed)))


def make_essential_counter_packed(
    essential_gene_positions: Dict[str, List[int]], width: int
):
    """Per-chunk essential-gene counter over PACKED masks: a gene with
    several mapped positions counts once if ANY is set; positions >=
    ``width`` are ignored. Returns ``counter(packed_chunk) -> counts``
    (range ``gm2/sample/count_essential``).

    The genes' positions become one table of (byte, bit mask, gene)
    entries sorted by byte, built here once; a chunk is one native pass
    that reads each row in address order, on host threads by row count
    (``host_counts.py``)."""
    genes = [g for g in ([p for p in ps if p < width]
                         for ps in essential_gene_positions.values()) if g]
    if not genes:
        return lambda chunk: np.zeros(np.asarray(chunk).shape[0], dtype=int)
    table = HC.EssentialTable(genes)

    def counter(packed_chunk: np.ndarray) -> np.ndarray:
        with span("gm2/sample/count_essential"):
            return table.count(packed_chunk, HC.threads_for(len(packed_chunk)))

    return counter


def count_essential_genes_packed(
    packed: np.ndarray,
    essential_gene_positions: Dict[str, List[int]],
    width: int,
    chunk_rows: int = 8192,
) -> np.ndarray:
    """:func:`count_essential_genes` on PACKED masks, one native pass over
    all rows (``chunk_rows`` is accepted and unused)."""
    return make_essential_counter_packed(essential_gene_positions, width)(packed)


def count_stats() -> dict:
    """The host counts' rows on the thread pool and on the calling thread
    alone, and the most threads a call used (``host_counts.count_stats``)."""
    return HC.count_stats()


def save_binary_npy_stream(
    packed: np.ndarray,
    input_dim: int,
    output_file: str,
    dtype=np.float32,
    chunk_rows: int = 2048,
) -> None:
    """The dense (N, input_dim) sample matrix as a .npy file, byte-equal to
    ``np.save(output_file, unpack(packed).astype(dtype))``, written a chunk
    of rows at a time from the packed bitmask."""
    packed = np.asarray(packed, np.uint8)
    n = packed.shape[0]
    header = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
              "fortran_order": False, "shape": (n, input_dim)}
    with open(output_file, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        for lo in range(0, n, chunk_rows):
            dense = K.unpack_bits(packed[lo:lo + chunk_rows], input_dim)
            f.write(np.ascontiguousarray(dense, dtype).tobytes())


def write_samples_csv_stream(
    packed: np.ndarray,
    all_genes: Sequence[str],
    output_file: str,
    gene_chunk: int = 2048,
) -> None:
    """Genes x samples CSV, byte-equal to :func:`write_samples_to_dataframe`
    of the unpacked matrix, emitted in blocks of gene rows straight from the
    packed bitmask (the dense transpose is never built).

    Each block's bits come from one ``np.unpackbits`` of a contiguous byte
    slice; each [',', digit] cell is one little-endian uint16 (0x302C +
    (bit << 8)), so a row is bytes, not formatted cells. Gene names follow
    csv.QUOTE_MINIMAL, as pandas writes them. Blocks shrink with the sample
    count so that their buffers stay near 128 MB."""
    import csv
    import io

    packed = np.asarray(packed, np.uint8)
    n = packed.shape[0]
    genes = list(all_genes)

    def field(s: str) -> str:
        s = str(s)
        if any(c in s for c in ',"\r\n'):
            buf = io.StringIO()
            csv.writer(buf, lineterminator="").writerow([s])
            return buf.getvalue()
        return s

    g_eff = max(16, min(gene_chunk, (128 << 20) // max(1, 2 * n)))
    header = ",".join(["Gene"] + [f"Sample_{i + 1}" for i in range(n)])
    with open(output_file, "wb") as f:
        f.write(header.encode() + b"\n")
        for lo in range(0, len(genes), g_eff):
            hi = min(lo + g_eff, len(genes))
            b0, b1 = lo >> 3, (hi + 7) >> 3
            bits = np.unpackbits(packed[:, b0:b1], axis=1,
                                 bitorder="little")[:, lo - 8 * b0: hi - 8 * b0]
            bits_t = np.ascontiguousarray(bits.T)  # (G, N)
            pairs = (0x302C + (bits_t.astype(np.uint16) << 8)).astype("<u2",
                                                                      copy=False)
            rows = pairs.view(np.uint8).reshape(hi - lo, 2 * n)
            out = bytearray()
            for i, g in enumerate(genes[lo:hi]):
                out += field(g).encode()
                out += rows[i].tobytes()
                out += b"\n"
            f.write(out)
