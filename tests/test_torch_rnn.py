"""The port's recurrent pieces against the JAX package's on the CPU:
`ops/rnn.py` (the torch-layout cells, masked steps and scans with resets
mid-sequence, the padded encodes at lengths 0, 1, mid and full, forward
and reversed within each row's length), `RNNStateEncoder` (GRU and LSTM,
single step and sequence) and `InstructionEncoder` (uni- and
bidirectional, LSTM and GRU, per-token outputs and final states) with
weights carried over by `from_jax`. Inputs come from numpy seeds; fp32,
within RNN_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from internnav_tpu.model.encoder import instruction as jinstr
from internnav_tpu.model.encoder import rnn_state as jrnn_state
from internnav_tpu.ops import rnn as jrnn
from internnav_tpu_torch.model.encoder import instruction as tinstr
from internnav_tpu_torch.model.encoder import rnn_state as trnn_state
from internnav_tpu_torch.model.weights.from_jax import cma_state_from_jax, state_dict_from_jax
from internnav_tpu_torch.ops import rnn as trnn

torch.set_num_threads(2)
#: fp32 recurrences over a few dozen steps, XLA's and torch's GEMM orders
RNN_TOL = 2e-5
IN, H, N, T = 6, 5, 4, 7


def params(kind: str, seed: int, i: int = IN, h: int = H):
    rs = np.random.RandomState(seed)
    g = (3 if kind == "GRU" else 4) * h
    return {"w_ih": rs.randn(g, i).astype(np.float32) * 0.5,
            "w_hh": rs.randn(g, h).astype(np.float32) * 0.5,
            "b_ih": rs.randn(g).astype(np.float32) * 0.1,
            "b_hh": rs.randn(g).astype(np.float32) * 0.1}


def to_t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def close(a, b, tol=RNN_TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy() if torch.is_tensor(b) else b,
                               atol=tol, rtol=tol)


def test_cells_equal_jax():
    rs = np.random.RandomState(1)
    x, h, c = (rs.randn(N, d).astype(np.float32) for d in (IN, H, H))
    p = params("GRU", 0)
    close(jrnn.gru_cell(p, x, h), trnn.gru_cell(to_t(p), torch.from_numpy(x), torch.from_numpy(h)))
    p = params("LSTM", 2)
    jh, jc = jrnn.lstm_cell(p, x, (h, c))
    th, tc = trnn.lstm_cell(to_t(p), torch.from_numpy(x), (torch.from_numpy(h),
                                                           torch.from_numpy(c)))
    close(jh, th)
    close(jc, tc)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
def test_masked_steps_and_scans_equal_jax(kind):
    """Resets mid-sequence: the carry is multiplied by the mask before the
    cell, so a 0 starts that row over from a zero state."""
    rs = np.random.RandomState(3)
    p = params(kind, 4)
    xs = rs.randn(T, N, IN).astype(np.float32)
    h0, c0 = rs.randn(N, H).astype(np.float32), rs.randn(N, H).astype(np.float32)
    masks = np.ones((T, N), np.float32)
    masks[0, 1] = masks[3, 0] = masks[3, 2] = masks[5, 3] = 0.0
    tp, txs, tm = to_t(p), torch.from_numpy(xs), torch.from_numpy(masks)
    th0, tc0 = torch.from_numpy(h0), torch.from_numpy(c0)
    if kind == "GRU":
        close(jrnn.masked_gru_step(p, xs[0], h0, masks[0]),
              trnn.masked_gru_step(tp, txs[0], th0, tm[0]))
        jys, jh = jrnn.masked_gru_scan(p, xs, h0, masks)
        tys, th = trnn.masked_gru_scan(tp, txs, th0, tm)
        close(jys, tys)
        close(jh, th)
        # a reset row equals a fresh scan from its reset step on
        _, fresh = trnn.masked_gru_scan(tp, txs[3:, :1], torch.zeros(1, H), tm[3:, :1])
        np.testing.assert_allclose(th[:1].numpy(), fresh.numpy(), atol=1e-6)
    else:
        jh, jc = jrnn.masked_lstm_step(p, xs[0], (h0, c0), masks[0])
        th, tc = trnn.masked_lstm_step(tp, txs[0], (th0, tc0), tm[0])
        close(jh, th)
        close(jc, tc)
        jys, (jh, jc) = jrnn.masked_lstm_scan(p, xs, (h0, c0), masks)
        tys, (th, tc) = trnn.masked_lstm_scan(tp, txs, (th0, tc0), tm)
        close(jys, tys)
        close(jh, th)
        close(jc, tc)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
@pytest.mark.parametrize("final_state_only", [True, False])
def test_padded_encodes_equal_jax(kind, final_state_only):
    """Lengths 0, 1, mid and full; outputs past a row's length are exact
    zeros, a row of length 0 encodes to zeros."""
    L = 9
    rs = np.random.RandomState(5)
    p = params(kind, 6)
    emb = rs.randn(N, L, IN).astype(np.float32)
    lengths = np.array([0, 1, 5, L], np.int32)
    enc_j = jrnn.gru_encode_padded if kind == "GRU" else jrnn.lstm_encode_padded
    enc_t = trnn.gru_encode_padded if kind == "GRU" else trnn.lstm_encode_padded
    want = enc_j(p, emb, lengths, final_state_only=final_state_only)
    got = enc_t(to_t(p), torch.from_numpy(emb), torch.from_numpy(lengths),
                final_state_only=final_state_only)
    close(want, got)
    if final_state_only:
        assert not got[0].any()
    else:
        for i, n in enumerate(lengths):
            assert not got[i, n:].any()
            assert n == 0 or got[i, :n].abs().min() > 0


def test_reverse_within_length():
    x = torch.arange(1, 13, dtype=torch.float32).reshape(3, 4, 1)
    lengths = torch.tensor([0, 2, 4])
    rev = trnn.reverse_within_length(x, lengths)
    assert rev[..., 0].tolist() == [[0, 0, 0, 0], [6, 5, 0, 0], [12, 11, 10, 9]]
    assert torch.equal(trnn.reverse_within_length(rev, lengths),
                       x * trnn.valid_positions(lengths, 4)[..., None])


def _jax_params(module, *args):
    """A JAX module's params from jax.eval_shape (no init run), drawn from
    a numpy seed: N(0, 0.3) leaves."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rs = np.random.RandomState(7)
    return jax.tree_util.tree_map(lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32), shapes)


class _Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
@pytest.mark.parametrize("seq", [False, True])
def test_rnn_state_encoder_equals_jax(kind, seq):
    rs = np.random.RandomState(8)
    layers = 1 if kind == "GRU" else 2
    x = rs.randn(*((T, N, IN) if seq else (N, IN))).astype(np.float32)
    states = rs.randn(N, layers, H).astype(np.float32)
    masks = (rs.rand(*((T, N) if seq else (N,))) > 0.3).astype(np.float32)
    jm = jrnn_state.build_rnn_state_encoder(IN, H, kind.lower())
    p = _jax_params(jm, x, states, masks)
    jy, js = jm.apply({"params": p}, x, states, masks)
    tm = trnn_state.build_rnn_state_encoder(IN, H, kind.lower())
    tm.load_state_dict(state_dict_from_jax(p, tm))
    assert tm.num_recurrent_layers == jm.num_recurrent_layers == layers
    ty, ts = tm(torch.from_numpy(x), torch.from_numpy(states), torch.from_numpy(masks))
    close(jy, ty)
    close(js, ts)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("final_state_only", [True, False])
def test_instruction_encoder_equals_jax(rnn_type, bidirectional, final_state_only):
    """Rows of 0, 1, a few and all tokens, one with a 0 inside (the
    length counts nonzero tokens), one with ids past the vocabulary
    (clipped)."""
    L, V, E, Hh = 10, 30, 6, 5
    tokens = np.zeros((5, L), np.int32)
    tokens[1, 0] = 4
    tokens[2, :4] = [3, 9, 28, 2]
    tokens[3, :] = np.arange(1, L + 1)
    tokens[4, :5] = [5, 0, 7, 44, 8]
    kw = dict(vocab_size=V, embedding_size=E, hidden_size=Hh, rnn_type=rnn_type,
              final_state_only=final_state_only, bidirectional=bidirectional)
    jm = jinstr.InstructionEncoder(**kw)
    p = _jax_params(jm, jnp.asarray(tokens))
    want = jm.apply({"params": p}, jnp.asarray(tokens))
    tm = tinstr.InstructionEncoder(**kw)
    holder = _Holder(instruction_encoder=tm)
    holder.load_state_dict(cma_state_from_jax({"instruction_encoder": p}, holder))
    got = tm(torch.from_numpy(tokens))
    assert tm.output_size == jm.output_size
    close(want, got)
    if not final_state_only:
        pad = (got == 0.0).all(dim=-1)
        assert pad.tolist() == np.asarray(jnp.all(want == 0.0, axis=-1)).tolist()
        assert pad[0].all() and not pad[3].any()


def test_load_glove_embeddings_equals_jax(tmp_path):
    import gzip
    import json

    table = np.random.RandomState(9).randn(5, 4).round(4).tolist()
    path = tmp_path / "glove.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(table, f)
    got, want = tinstr.load_glove_embeddings(str(path)), jinstr.load_glove_embeddings(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
