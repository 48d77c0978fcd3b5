"""Sample mode's pieces in the port against the JAX package: the samplers
(dense focused, packed, the feature-bits decoder), the analytics and
writers, the latent means, and the import of reference ``.pt`` state dicts.

Both packages load one JAX-written checkpoint and run at float32 on the
CPU. The latents agree to a few ulp, so a decoded bit can only differ where
its logit lies within rounding of 0: every bit comparison first asserts that
no reference logit of its latents lies within MARGIN of 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genome_minimizer_2_torch.core import prng as tprng
from genome_minimizer_2_torch.ops.kernels import unpack_bits
from genome_minimizer_2_torch.sample import sampler as tsmp
from genome_minimizer_2_torch.utils import torch_import as tti
from genome_minimizer_2_tpu.core.prng import draw_latents as jdraw
from genome_minimizer_2_tpu.models import vae as jvae
from genome_minimizer_2_tpu.sample import sampler as jsmp
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils import torch_import as jti
from genome_minimizer_2_tpu.utils.config import ExperimentConfig

D, H, L = 200, 24, 4
MARGIN = 1e-5
N_PROBES = 16


@pytest.fixture(scope="module")
def samplers(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_sample")
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    params, stats = jvae.init(cfg, jax.random.key(5))
    ckpt = d / "m.npz"
    jckpt.save_checkpoint(ckpt, params, stats,
                          ExperimentConfig(hidden_dim=H, latent_dim=L),
                          extra={"input_dim": D})
    js, _ = jsmp.load_sampler(str(ckpt))
    js.chunk_size = 16
    ts, _ = tsmp.load_sampler(str(ckpt), device="cpu", chunk_size=16)
    return js, ts


def _assert_margin(js, z):
    logits, _ = jvae.decode_logits(js.cfg, js.params, js.batch_stats,
                                   jnp.asarray(z), False)
    m = float(np.abs(np.asarray(logits)[:, :D]).min())
    assert m >= MARGIN, f"a reference logit lies {m} from 0"


def _focused_z(js, ts, seed, n, noise):
    """The focused latents of both packages' key split, after asserting
    that both pick the same anchor."""
    probe, noise_key = jax.random.split(jax.random.key(seed))
    want = js.focused_anchor(probe, N_PROBES)
    got = ts.focused_anchor(tprng.split(tprng.key(seed, "cpu"))[0], N_PROBES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    return want + np.asarray(jdraw(noise_key, jnp.arange(n), L)) * noise


def test_sample_focused_dense_bit_equal_to_jax(samplers):
    js, ts = samplers
    n, seed, noise = 21, 4, 0.2
    _assert_margin(js, _focused_z(js, ts, seed, n, noise))
    jb, jp, jz = js.sample_focused(jax.random.key(seed), n, noise_level=noise,
                                   n_probes=N_PROBES, return_probs=True)
    tb, tp, tz = ts.sample_focused(tprng.key(seed, "cpu"), n, noise_level=noise,
                                   n_probes=N_PROBES, return_probs=True)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tz, jz, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert ts.sample_focused(tprng.key(seed, "cpu"), n, n_probes=N_PROBES)[1] is None


@pytest.mark.parametrize("mode", ["default", "focused"])
def test_packed_samplers_bit_equal_to_jax(samplers, mode):
    js, ts = samplers
    n, seed = 37, 4  # 37 rows: chunks of 16 with a ragged tail
    if mode == "default":
        _assert_margin(js, np.asarray(jdraw(jax.random.key(seed), jnp.arange(n), L)))
        jp, jz = js.sample_packed(jax.random.key(seed), n)
        tp, tz = ts.sample_packed(tprng.key(seed, "cpu"), n)
    else:
        _assert_margin(js, _focused_z(js, ts, seed, n, 0.1))
        jp, jz = js.sample_focused_packed(jax.random.key(seed), n, n_probes=N_PROBES)
        tp, tz = ts.sample_focused_packed(tprng.key(seed, "cpu"), n,
                                          n_probes=N_PROBES)
    assert tp.shape == (n, (D + 7) // 8) and tp.dtype == np.uint8
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tz, jz, rtol=1e-6, atol=1e-6)


def _feature_lookup():
    """col_idx over the gene columns with -1 entries (a gene that is not a
    column), essential and not, and columns in the last byte."""
    rng = np.random.RandomState(1)
    col_idx = np.concatenate([rng.randint(0, D, 60), [-1, -1, D - 1, 0, -1]])
    ess = np.concatenate([rng.rand(60) < 0.2, [True, False, False, True, True]])
    return col_idx.astype(np.int64), ess


@pytest.mark.parametrize("rows,pad_to", [(13, None), (13, 16), (16, None)])
def test_feature_decoder_bit_equal_to_jax(samplers, rows, pad_to):
    js, ts = samplers
    col_idx, ess = _feature_lookup()
    F = col_idx.size
    z = np.asarray(jdraw(jax.random.key(9), jnp.arange(rows), L))
    _assert_margin(js, z)
    got = ts.make_feature_decoder(col_idx, ess)(z, pad_to=pad_to).wait()
    want = np.asarray(js.make_feature_decoder(col_idx, ess)(z, pad_to=pad_to))
    assert got.shape == (max(rows, pad_to or 0), (F + 7) // 8)
    np.testing.assert_array_equal(got, want)
    # keep = present | essential, the -1 columns reduce to the flag
    binary = ts.decode_binary(z).astype(bool)
    padded = np.concatenate([binary, np.zeros((rows, 1), bool)], axis=1)
    np.testing.assert_array_equal(unpack_bits(got[:rows], F).astype(bool),
                                  padded[:, col_idx] | ess[None, :])


def test_feature_decoder_rejects_columns_beyond_the_model(samplers):
    _, ts = samplers
    with pytest.raises(ValueError, match="col_idx"):
        ts.make_feature_decoder(np.array([0, D]), np.array([False, False]))


@pytest.fixture()
def packed_samples():
    rng = np.random.RandomState(4)
    n, width = 37, 100
    bits = (rng.rand(n, width) < 0.45).astype(np.uint8)
    packed = np.packbits(bits, axis=1, bitorder="little")
    genes = [f"g{i:03d}" for i in range(width)]
    genes[3], genes[17], genes[40] = "a,b", 'q"x', "sp ace"
    return packed, bits, genes


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64])
def test_save_binary_npy_stream_byte_equal_to_jax(packed_samples, tmp_path, dtype):
    packed, bits, _ = packed_samples
    t, j, ref = tmp_path / "t.npy", tmp_path / "j.npy", tmp_path / "ref.npy"
    tsmp.save_binary_npy_stream(packed, bits.shape[1], str(t), dtype=dtype,
                                chunk_rows=7)
    jsmp.save_binary_npy_stream(packed, bits.shape[1], str(j), dtype=dtype,
                                chunk_rows=5)
    np.save(ref, bits.astype(dtype))
    assert t.read_bytes() == j.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("gene_chunk", [16, 2048])
def test_samples_csv_writers_byte_equal_to_jax(packed_samples, tmp_path, gene_chunk):
    packed, bits, genes = packed_samples
    paths = {k: tmp_path / f"{k}.csv" for k in ("t_stream", "j_stream",
                                                "t_df", "j_df")}
    tsmp.write_samples_csv_stream(packed, genes, str(paths["t_stream"]),
                                  gene_chunk=gene_chunk)
    jsmp.write_samples_csv_stream(packed, genes, str(paths["j_stream"]),
                                  gene_chunk=gene_chunk)
    tsmp.write_samples_to_dataframe(bits, genes, str(paths["t_df"]))
    jsmp.write_samples_to_dataframe(bits, genes, str(paths["j_df"]))
    data = {k: p.read_bytes() for k, p in paths.items()}
    assert len(set(data.values())) == 1
    assert b'"a,b",' in data["t_stream"] and b'"q""x",' in data["t_stream"]


def test_essential_counters_equal_to_jax(packed_samples):
    packed, bits, _ = packed_samples
    positions = {"a": [1, 5], "b": [63], "c": [99], "d": [2, 40, 41],
                 "out": [100, 150], "part": [7, 300]}
    want = jsmp.count_essential_genes(bits, positions)
    np.testing.assert_array_equal(tsmp.count_essential_genes(bits, positions), want)
    np.testing.assert_array_equal(
        tsmp.count_essential_genes_packed(packed, positions, 100, chunk_rows=8),
        jsmp.count_essential_genes_packed(packed, positions, 100))
    np.testing.assert_array_equal(
        tsmp.count_essential_genes_packed(packed, positions, 100), want)
    assert tsmp.count_essential_genes(bits, {"x": [500]}).sum() == 0


@pytest.mark.parametrize(
    "width,rows,n_genes,most",
    [(w, r, 20, 5) for w in (1, 7, 8, 9, 13, 64, 6880) for r in (0, 1024)]
    + [(6880, 1024, 300, 3)]
    + [(13, r, 20, 5) for r in (1, 7, 63, 64, 1023, 1025)]
    + [(6880, r, 300, 3) for r in (7, 1023, 1025)])
def test_packed_counts_by_word_equal_to_jax(width, rows, n_genes, most):
    """Genome sizes and essential counts of packed chunks, word by word,
    against the JAX package's per-byte counts: contiguous chunks, a column
    slice of a wider array, a column-strided view, row chunks shorter than
    the chunk; genes of 1 to ``most`` positions, two positions in one byte,
    positions at or beyond the gene width, a gene with none in range, and
    no genes. The last case is the sampling cell's shape: 1,024 x 6,880
    bytes, 300 genes of 1-3 columns."""
    rng = np.random.default_rng([width, rows, n_genes])
    wide = rng.integers(0, 256, (rows, 2 * width + 3), dtype=np.uint8)
    genes = 8 * width - 3
    views = (np.ascontiguousarray(wide[:, :width]), wide[:, :width],
             wide[:, ::2][:, :width])
    for packed in views:
        want = jsmp.popcount_rows(packed)
        np.testing.assert_array_equal(tsmp.popcount_rows(packed), want)
        np.testing.assert_array_equal(tsmp.popcount_rows(packed, chunk_rows=100),
                                      want)
    positions = {f"g{i}": rng.integers(0, genes, rng.integers(1, most + 1)).tolist()
                 for i in range(n_genes)}
    positions.update({"one_byte": [genes - 1, genes - 2], "edge": [genes - 1, genes],
                      "beyond": [genes, 8 * width, 8 * width + 9]})
    for packed in views:
        want = jsmp.make_essential_counter_packed(positions, genes)(packed)
        got = tsmp.make_essential_counter_packed(positions, genes)(packed)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert tsmp.make_essential_counter_packed({}, genes)(packed).tolist() == [0] * rows
    np.testing.assert_array_equal(
        tsmp.count_essential_genes_packed(views[1], positions, genes, chunk_rows=100),
        jsmp.count_essential_genes_packed(views[1], positions, genes))


POOL_WIDTH = 861  # bytes: 6,883 genes, not a multiple of 8 bytes
POOL_ROWS = (0, 1, 7, 63, 64, 1023, 1024, 1025)


@pytest.fixture(scope="module")
def pool_cases():
    """Rows of every count in POOL_ROWS in four layouts (contiguous, every
    other row of a wider array, a column slice, a column-strided view),
    genes of 1-3 positions with two in one byte and some at or beyond the
    gene width, and each layout's counts from the JAX package: per-byte
    sizes, the packed counter and ``count_essential_genes`` on the
    unpacked rows."""
    rng = np.random.default_rng(22)
    genes = 8 * POOL_WIDTH - 5
    positions = {f"g{i}": rng.integers(0, genes, rng.integers(1, 4)).tolist()
                 for i in range(40)}
    positions.update({"one_byte": [16, 17], "edge": [genes - 1, genes],
                      "beyond": [genes, genes + 3]})
    cases = []
    for rows in POOL_ROWS:
        wide = rng.integers(0, 256, (2 * rows, 2 * POOL_WIDTH + 1), dtype=np.uint8)
        for packed in (np.ascontiguousarray(wide[:rows, :POOL_WIDTH]),
                       wide[::2, :POOL_WIDTH], wide[:rows, 3:3 + POOL_WIDTH],
                       wide[:rows, ::2][:, :POOL_WIDTH]):
            bits = np.unpackbits(packed, axis=1, bitorder="little")[:, :genes]
            want = jsmp.make_essential_counter_packed(positions, genes)(packed)
            np.testing.assert_array_equal(
                jsmp.count_essential_genes(bits, positions), want)
            cases.append((packed, jsmp.popcount_rows(packed), want))
    return positions, genes, cases


@pytest.mark.parametrize("threads", range(1, 9))
def test_native_counts_equal_at_every_pool_size(pool_cases, threads):
    """The native row passes on 1 to 8 threads give the JAX package's
    genome sizes and essential counts at every row count and layout, and
    zeros with no genes."""
    from genome_minimizer_2_torch.sample import host_counts as HC

    positions, genes, cases = pool_cases
    table = HC.EssentialTable([[p for p in ps if p < genes]
                               for ps in positions.values()
                               if any(p < genes for p in ps)])
    for packed, sizes, ess in cases:
        rows = HC.as_rows(packed)
        assert rows.strides[1] == 1 or not rows.size
        if packed.strides[1] == 1 and packed.size:
            assert np.shares_memory(rows, packed)  # read in place, no copy
        got = HC.popcount_rows(rows, threads)
        np.testing.assert_array_equal(got, sizes)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(table.count(rows, threads), ess)
    packed = cases[-1][0]
    assert tsmp.make_essential_counter_packed({}, genes)(packed).tolist() == [0] * len(packed)
    assert tsmp.make_essential_counter_packed({"b": [genes]}, genes)(packed).sum() == 0


def test_native_counter_indexes_as_numpy():
    """A negative position counts from the row's end as numpy's indexing
    does, and a position past the rows' bytes raises IndexError."""
    packed = np.random.default_rng(3).integers(0, 256, (300, 9), dtype=np.uint8)
    positions = {"neg": [-3], "last": [8 * 9 - 1, 2]}
    np.testing.assert_array_equal(
        tsmp.make_essential_counter_packed(positions, 72)(packed),
        jsmp.make_essential_counter_packed(positions, 72)(packed))
    with pytest.raises(IndexError):
        tsmp.make_essential_counter_packed({"far": [80]}, 100)(packed)


def test_native_counts_from_many_threads_at_once():
    """Twelve Python threads count at once on pool sizes 1 to 8, more
    callers than cores: every answer is exact, every call ends, and the
    row counters lose no update."""
    import sys
    import threading

    from genome_minimizer_2_torch.sample import host_counts as HC

    rng = np.random.default_rng(12)
    packed = rng.integers(0, 256, (700, 133), dtype=np.uint8)
    sizes = jsmp.popcount_rows(packed)
    positions = {f"g{i}": rng.integers(0, 8 * 133, rng.integers(1, 4)).tolist()
                 for i in range(30)}
    ess = jsmp.make_essential_counter_packed(positions, 8 * 133)(packed)
    table = HC.EssentialTable(list(positions.values()))
    wrong, rows_counted = [], [0] * 12

    def work(k):
        for i in range(40):
            n, threads = (7, 64, 300, 700)[(k + i) % 4], 1 + (k * 5 + i) % 8
            if not (np.array_equal(HC.popcount_rows(packed[:n], threads), sizes[:n])
                    and np.array_equal(table.count(packed[:n], threads), ess[:n])):
                wrong.append((k, i))
            rows_counted[k] += 2 * n

    before = HC.count_stats()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=work, args=(k,)) for k in range(12)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert wrong == []
    after = HC.count_stats()
    moved = sum(after[k] - before[k] for k in ("pooled_rows", "inline_rows"))
    assert moved == sum(rows_counted)


def test_native_counts_in_a_forked_child():
    """A child forked after the pool has started has none of its threads:
    its counts start a pool of their own and end, exact."""
    import os
    import time

    from genome_minimizer_2_torch.sample import host_counts as HC

    packed = np.random.default_rng(6).integers(0, 256, (512, 40), dtype=np.uint8)
    want = HC.popcount_rows(packed, 8)
    pid = os.fork()
    if pid == 0:  # the child: report by exit code only
        ok = np.array_equal(HC.popcount_rows(packed, 8), want)
        os._exit(0 if ok else 1)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's count did not end")
    assert os.waitstatus_to_exitcode(status) == 0


def test_count_stats_show_the_pool_on_chunks_and_not_on_small_inputs(monkeypatch):
    """A 1,024-row chunk is counted on the pool and a 7-row one on the
    calling thread, on a host with 8 cores to run on."""
    from genome_minimizer_2_torch.sample import host_counts as HC

    monkeypatch.setattr(HC, "_cores", 8)
    counter = tsmp.make_essential_counter_packed({"a": [1, 9], "b": [40]}, 6880 * 8)
    chunk = np.random.default_rng(4).integers(0, 256, (1024, 6880), dtype=np.uint8)
    for rows, pooled in ((1024, True), (7, False)):
        before = tsmp.count_stats()
        tsmp.popcount_rows(chunk[:rows])
        counter(chunk[:rows])
        after = tsmp.count_stats()
        moved = {k: after[k] - before[k] for k in ("pooled_rows", "inline_rows")}
        assert moved == ({"pooled_rows": 2 * rows, "inline_rows": 0} if pooled
                         else {"pooled_rows": 0, "inline_rows": 2 * rows})
    assert after["threads"] >= 2


def test_encode_means_match_jax(samplers):
    js, ts = samplers
    x = (np.random.RandomState(2).rand(45, D) < 0.4).astype(np.float32)
    want = js.encode_means(x, batch_size=16)
    got = ts.encode_means(x, batch_size=16)
    assert got.shape == (45, L) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# reference .pt state dicts
# ---------------------------------------------------------------------------

def _reference_state_dict(params, stats, d: int = D) -> dict:
    """The reference model's state dict from a JAX-initialized model of
    ``d`` genes: the inverse of the importer's key map (weights back to
    torch's (out, in), the gene axis cut to its true width), with random
    biases and BatchNorm statistics."""
    sd = {}
    rng = np.random.RandomState(0)  # biases and running statistics

    def noise(a, scale):
        return (np.asarray(a) + scale * rng.randn(*np.shape(a))).astype(np.float32)

    def lin(tname, p, rows=None, cols=None):
        w = np.asarray(p["w"])[:rows, :cols]
        sd[f"{tname}.weight"] = torch.tensor(w.T.copy())
        sd[f"{tname}.bias"] = torch.tensor(noise(np.asarray(p["b"])[:cols], 0.1))

    def bn(tname, p, s):
        sd[f"{tname}.weight"] = torch.tensor(noise(p["bn"]["scale"], 0.1))
        sd[f"{tname}.bias"] = torch.tensor(noise(p["bn"]["bias"], 0.1))
        sd[f"{tname}.running_mean"] = torch.tensor(noise(s["mean"], 0.1))
        sd[f"{tname}.running_var"] = torch.tensor(np.abs(noise(s["var"], 0.2)))
        sd[f"{tname}.num_batches_tracked"] = torch.tensor(7)

    for tree in ("encoder", "decoder"):
        for i in range(3):
            lin(f"{tree}.{3 * i}", params[tree][i],
                rows=d if (tree, i) == ("encoder", 0) else None)
            bn(f"{tree}.{3 * i + 1}", params[tree][i], stats[tree][i])
    lin("mean_layer", params["mean"])
    lin("logvar_layer", params["logvar"])
    lin("decoder.9", params["decoder"][3], cols=d)
    return sd


def test_pt_import_equal_to_jax_and_decodes_equal_bits(tmp_path):
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    params, stats = jvae.init(cfg, jax.random.key(8))
    # the BatchNorms' num_batches_tracked are int tensors: both importers
    # take every value as float32 and ignore those keys
    sd = _reference_state_dict(params, stats)
    pt = tmp_path / "saved_VAE_v1_epochs_3.pt"
    torch.save(sd, pt)

    j_out = tmp_path / "jax.npz"
    jti.convert_file(str(pt), str(j_out), trainer_version="v1")
    t_out = tti.ensure_npz(str(pt))  # in-process; the version from the name
    assert t_out == str(pt) + ".npz"
    with np.load(j_out) as jz, np.load(t_out) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
            assert tz[k].dtype == jz[k].dtype, k
    mtime = (tmp_path / "saved_VAE_v1_epochs_3.pt.npz").stat().st_mtime_ns
    assert tti.ensure_npz(str(pt)) == t_out  # the cache is reused
    assert (tmp_path / "saved_VAE_v1_epochs_3.pt.npz").stat().st_mtime_ns == mtime

    js, jconf = jsmp.load_sampler(str(j_out))
    ts, tconf = tsmp.load_sampler(t_out, device="cpu")
    assert jconf.trainer_version == tconf.trainer_version == "v1"
    z = np.asarray(jdraw(jax.random.key(2), jnp.arange(24), L))
    _assert_margin(js, z)
    np.testing.assert_array_equal(ts.decode_binary(z), js.decode_binary(z))


def test_jax_cache_of_a_pt_is_the_port_cache(tmp_path):
    """The JAX package's ``ensure_npz`` (a torch subprocess) writes the
    same ``.pt.npz`` sibling as the port's in-process conversion."""
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    params, stats = jvae.init(cfg, jax.random.key(3))
    sd = _reference_state_dict(params, stats)
    paths = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        pt = tmp_path / side / "saved_VAE_v2.pt"
        torch.save(sd, pt)
        paths[side] = (jti if side == "jax" else tti).ensure_npz(str(pt))
    with np.load(paths["jax"]) as jz, np.load(paths["port"]) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        assert all(np.array_equal(jz[k], tz[k]) for k in jz.files)


@pytest.mark.parametrize("name,want", [("SAVED_vae_V3.pt", "v3"),
                                       ("saved_VAE_v0_epochs_10.pt", "v0"),
                                       ("model.pt", None)])
def test_infer_version_from_filename_equal_to_jax(name, want):
    assert tti.infer_version_from_filename(name) == want \
        == jti.infer_version_from_filename(name)


def test_ensure_npz_passthrough_and_unknown_version(tmp_path):
    assert tti.ensure_npz("/some/model.npz") == "/some/model.npz"
    pt = tmp_path / "mystery.pt"
    pt.write_bytes(b"x")
    with pytest.raises(ValueError, match="version"):
        tti.ensure_npz(str(pt))
