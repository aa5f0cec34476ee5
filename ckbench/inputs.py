"""Inputs made from ``--seed``: the word map, the split and the existing
captions, and the shared draw of an architecture's weights
(``archs/<arch>.py::make_weights``). Both the program and the plain
reference get these.

``uniform_weights`` draws flat float32 arrays from a table of (name,
shape, scale) on the device in one call (uniform in [-1, 1), then scaled
per array; scale 0 gives zeros), each array on a 256-byte boundary of the
buffer. ``lstm_arrays`` and ``attention_arrays`` are the table's rows of
an LSTM and of additive attention with the reference's initial
distributions: uniform with torch-style scales (H^-1/2 for recurrent and
output kernels, the input width^-1/2 for attention key and query kernels,
A^-1/2 for the score vector), zero attention bias.
"""

from __future__ import annotations

import numpy as np
import torch

from ckbench.traffic.generator import words_pattern

PAD, UNK, START, END = "<pad>", "<unk>", "<start>", "<end>"


def seed_sequence(seed: int, *tag: int) -> np.random.SeedSequence:
    """A numpy seed sequence for ``seed`` (any integer) and a tag."""
    return np.random.SeedSequence([int(seed) % 2 ** 64, *tag])


def torch_seed(seed: int, tag: int) -> int:
    return int(seed_sequence(seed, tag).generate_state(1, np.uint64)[0]
               % 2 ** 63)


def lstm_arrays(prefix, d_in, H):
    """(name, shape, scale) of an LSTM's input and recurrent kernels and
    its bias, gates i|f|g|o."""
    s = H ** -0.5
    return [(f"{prefix}/wx", (d_in, 4 * H), s),
            (f"{prefix}/wh", (H, 4 * H), s), (f"{prefix}/b", (4 * H,), s)]


def attention_arrays(prefix, d_enc, d_q, A):
    """(name, shape, scale) of additive attention's key and query kernels,
    score vector and bias."""
    return [(f"{prefix}/w_enc", (d_enc, A), d_enc ** -0.5),
            (f"{prefix}/w_q", (d_q, A), d_q ** -0.5),
            (f"{prefix}/v", (A,), A ** -0.5), (f"{prefix}/b", (A,), 0.0)]


def uniform_weights(table, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} of every (name, shape, scale)
    of ``table``, from ``seed``."""
    offsets, total = [], 0
    for _, shape, _ in table:
        offsets.append(total)
        total += -(-int(np.prod(shape)) // 64) * 64
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out = {}
    for (name, shape, scale), lo in zip(table, offsets):
        t = flat[lo:lo + int(np.prod(shape))].view(shape)
        out[name] = t.mul_(scale) if scale else t.zero_()
    return out


def word_map(vocab_size: int) -> dict[str, int]:
    """<pad> = 0, words 1 .. V-4, then <unk>, <start>, <end> (the
    reference's word-map layout)."""
    n = vocab_size - 4
    w2i = {f"w{i:05d}": i for i in range(1, n + 1)}
    w2i.update({UNK: n + 1, START: n + 2, END: n + 3, PAD: 0})
    return w2i


def detokenize(id2word: dict, ids, end_id: int) -> str:
    """Ids to the served caption: stop at <end>, drop <pad> and <start>."""
    out = []
    for i in ids:
        i = int(i)
        if i == end_id:
            break
        if i == 0 or id2word.get(i) == START:
            continue
        out.append(id2word.get(i, UNK))
    return " ".join(out)


def encode_caption(w2i: dict, words: list[str], max_len: int):
    """<start> words <end>, cut to ``max_len`` and padded: (ids, length)."""
    ids = [w2i[START]] + [w2i.get(w, w2i[UNK]) for w in words][:max_len - 2] \
        + [w2i[END]]
    return ids + [0] * (max_len - len(ids)), len(ids)


def make_split(m: dict, n_images: int, lengths: tuple[int, int], seed: int,
               max_len: int, device):
    """A test split: features [N, R, F] float32 on the host (drawn on the
    device, standard normal), existing caption ids [N, max_len] int32 of
    words (ids 4 .. V-3 as in the reference's smoke batch) and their
    lengths, every length of ``lengths`` equally often."""
    R, F, V = m["num_regions"], m["feat_dim"], m["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    feats = torch.empty((n_images, R, F), dtype=torch.float32)
    step = max(1, (1 << 27) // (R * F))  # about 512 MiB a draw
    for lo in range(0, n_images, step):
        hi = min(n_images, lo + step)
        feats[lo:hi] = torch.randn((hi - lo, R, F), generator=gen,
                                   device=device).cpu()
    rng = np.random.default_rng(seed_sequence(seed, 3))
    existing = rng.integers(4, V - 2, (n_images, max_len)).astype(np.int32)
    existing_len = words_pattern(n_images, *lengths, rng).astype(np.int32)
    return feats.numpy(), existing, existing_len

