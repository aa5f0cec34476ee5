"""Automatic name-map fitting for unknown torch checkpoint layouts
(``captionkit.convert.fit_names``, copied: pure Python, no JAX).

A released checkpoint may use module names this repo cannot know
today. ``torch_import`` already makes the
names a data table; this module goes one step further and INFERS the
layout from parameter *shapes alone*, so fitting a real checkpoint is one
command rather than a by-hand JSON edit.

How: the architecture fixes every parameter's shape exactly (given the
paper dims V/E/H/A/F). Each logical component — an LSTM, an additive
attention block, a Linear, the embedding — has a characteristic multiset
of shapes, so we match components to checkpoint module subtrees by shape
signature, then match leaves within each component. Where shapes alone
are ambiguous (e.g. DCNet's f_beta/init_h/init_c are all [H,H]+[H];
weight_ih vs weight_hh when E==H), conventional name substrings break the
tie, and every other consistent assignment is returned as a ranked
*alternate* so the parity gate (greedy-identical / CIDEr±0.2) can be run
over the candidates to pick the numerically right one — shapes cannot
decide those cases, only behavior can.

Output is a key TRANSLATION (canonical tutorial-family key <- raw key),
strictly more expressive than a torch_import name-map override (it can
express per-module leaf conventions, e.g. nn.LSTM's ``weight_ih_l0`` next
to an LSTMCell's ``weight_ih``). The translated dict feeds
``params_from_state_dict`` with the default map; the converter's strict
key exhaustion then re-checks that nothing was dropped.
"""

from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

Shape = tuple[int, ...]

# Conventional-name tiebreakers, searched as substrings of the lowercased
# raw key path. Order within a list = decreasing specificity; score is
# (len of matched hint) so longer, more specific matches dominate.
_HINTS: dict[str, list[str]] = {
    "weight_ih": ["weight_ih", "w_ih", "ih"],
    "weight_hh": ["weight_hh", "w_hh", "hh"],
    "encoder_att": ["encoder_att", "enc"],
    "decoder_att": ["decoder_att", "dec", "query"],
    "f_beta": ["f_beta", "beta", "gate"],
    "init_h": ["init_h"],
    "init_c": ["init_c"],
    "weight_rh": ["weight_rh", "rh"],
    "weight_rc": ["weight_rc", "rc"],
    "vis_attention": ["vis", "visual"],
    "scma": ["scma", "mem", "copy"],
    "attention": ["att"],
    "encoder": ["encoder", "enc"],
    "decode_step": ["decode", "dec", "lstm"],
    "att_lstm": ["att_lstm", "att", "top"],
    "lang_lstm": ["lang", "copy"],
    "embedding": ["embed", "emb"],
    "fc": ["fc", "logit", "out"],
}

_MAX_BRANCHES = 48


def _hint_score(raw_path: str, target: str) -> int:
    low = raw_path.lower()
    for h in _HINTS.get(target, []):
        if h in low:
            return len(h)
    return 0


@dataclass
class _Comp:
    """One expected logical component."""

    name: str  # canonical prefix, e.g. "vis_attention"
    kind: str  # emb | lstm | attention | linear | copy_lstm
    dims: dict  # kind-specific dims


@dataclass
class FitResult:
    translation: dict[str, str]  # canonical key -> raw key (best fit)
    alternates: list[dict[str, str]] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)
    unmatched_raw: list[str] = field(default_factory=list)

    @property
    def candidates(self) -> list[dict[str, str]]:
        return [self.translation, *self.alternates]


def expected_components(arch: str, mcfg) -> list[_Comp]:
    V, E, H, A = (mcfg.vocab_size, mcfg.emb_dim, mcfg.hidden_dim,
                  mcfg.att_dim)
    F = mcfg.feat_dim
    if arch == "editnet":
        return [
            _Comp("embedding", "emb", dict(shape=(V, E))),
            _Comp("encoder", "lstm", dict(h=H, in_dim=E)),
            _Comp("att_lstm", "lstm", dict(h=H, in_dim=E + F + H)),
            _Comp("vis_attention", "attention", dict(a=A, enc=F, q=H)),
            _Comp("f_beta", "linear", dict(out=F, in_dim=H)),
            _Comp("scma", "attention", dict(a=A, enc=H, q=H)),
            _Comp("lang_lstm", "copy_lstm", dict(h=H, in_dim=F + H)),
            _Comp("fc", "linear", dict(out=V, in_dim=H)),
        ]
    if arch == "dcnet":
        visual = bool(getattr(mcfg, "dcnet_use_visual", False))
        dec_in = E + H + (F if visual else 0)
        comps = [
            _Comp("embedding", "emb", dict(shape=(V, E))),
            _Comp("encoder", "lstm", dict(h=H, in_dim=E)),
            _Comp("attention", "attention", dict(a=A, enc=H, q=H)),
            _Comp("f_beta", "linear", dict(out=H, in_dim=H)),
            _Comp("decode_step", "lstm", dict(h=H, in_dim=dec_in)),
            _Comp("init_h", "linear", dict(out=H, in_dim=H)),
            _Comp("init_c", "linear", dict(out=H, in_dim=H)),
            _Comp("fc", "linear", dict(out=V, in_dim=H)),
        ]
        if visual:
            comps.append(
                _Comp("vis_attention", "attention", dict(a=A, enc=F, q=H))
            )
        return comps
    raise ValueError(f"unknown arch {arch!r}")


def _signatures(comp: _Comp) -> list[Counter]:
    """Shape multisets this component can present (optional members give
    more than one acceptable signature)."""
    d = comp.dims
    if comp.kind == "emb":
        return [Counter([d["shape"]])]
    if comp.kind == "lstm":
        h, i = d["h"], d["in_dim"]
        return [Counter([(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)])]
    if comp.kind == "attention":
        a, enc, q = d["a"], d["enc"], d["q"]
        base = [(a, enc), (a, q), (a,), (a,), (1, a)]
        return [Counter(base + [(1,)]), Counter(base)]  # full_att bias opt.
    if comp.kind == "linear":
        return [Counter([(d["out"], d["in_dim"]), (d["out"],)])]
    if comp.kind == "copy_lstm":
        h, i = d["h"], d["in_dim"]
        lstm = [(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)]
        extras = [(h, i), (h, h), (h, h), (h,)]
        return [Counter(lstm + extras)]
    raise AssertionError(comp.kind)


def _subtree(pool: Mapping[str, Shape], prefix: str) -> dict[str, Shape]:
    if prefix == "":
        return dict(pool)
    if prefix in pool:  # a full key acting as a single-tensor "subtree"
        return {prefix: pool[prefix]}
    dot = prefix + "."
    return {k: v for k, v in pool.items() if k.startswith(dot)}


def _all_prefixes(pool: Mapping[str, Shape]) -> list[str]:
    seen = {""}
    for k in pool:
        parts = k.split(".")
        for i in range(1, len(parts)):
            seen.add(".".join(parts[:i]))
    return sorted(seen, key=lambda p: (-p.count("."), p))  # deepest first


def _component_candidates(
    comp: _Comp, pool: Mapping[str, Shape]
) -> list[str]:
    """Prefixes whose subtree shape-multiset equals one of the component's
    signatures. Deepest-first so the minimal enclosing module wins when an
    outer prefix would also match (single-component subtrees)."""
    sigs = _signatures(comp)
    single = all(sum(s.values()) == 1 for s in sigs)
    # Single-tensor components (the embedding) may live at a flat key with
    # no module prefix — the keys themselves are then the candidates.
    probes = sorted(pool) if single else _all_prefixes(pool)
    out: list[str] = []
    for p in probes:
        sub = _subtree(pool, p)
        c = Counter(sub.values())
        if any(c == s for s in sigs):
            # skip ancestors of an already-found candidate (same multiset
            # through a chain of single-child wrappers): keep deepest only.
            if any(o == "" or p == "" or o.startswith(p + ".") for o in out):
                continue
            out.append(p)
    return out


# ----------------------------------------------------------- leaf matching


def _branch(options: list[list[tuple[dict[str, str], int, list[str]]]]):
    """Cartesian product over per-tie options, each option = (partial
    translation, hint score, notes). Yields combined tuples."""
    for combo in itertools.product(*options):
        trans: dict[str, str] = {}
        score = 0
        notes: list[str] = []
        for t, s, n in combo:
            trans.update(t)
            score += s
            notes.extend(n)
        yield trans, score, notes


def _leaf(prefix: str, key: str) -> str:
    return key if prefix == "" else key[len(prefix) + 1:]


def _match_lstm(comp_name: str, prefix: str, sub: Mapping[str, Shape],
                h: int, in_dim: int):
    """Options for an LSTM unit. bias_ih/bias_hh are summed by the
    converter, so their assignment is tie-free by construction."""
    two_d = sorted(k for k, s in sub.items() if len(s) == 2)
    one_d = sorted(k for k, s in sub.items() if len(s) == 1)
    b1, b2 = one_d
    bias = {f"{comp_name}.bias_ih": b1, f"{comp_name}.bias_hh": b2}
    if in_dim != h:
        ih = next(k for k in two_d if sub[k][1] == in_dim)
        hh = next(k for k in two_d if sub[k][1] == h)
        return [[({f"{comp_name}.weight_ih": ih,
                   f"{comp_name}.weight_hh": hh, **bias}, 0, [])]]
    # in_dim == h: both 2D shapes identical — rank by ih/hh name hints.
    opts = []
    for ih, hh in [(two_d[0], two_d[1]), (two_d[1], two_d[0])]:
        s = _hint_score(ih, "weight_ih") + _hint_score(hh, "weight_hh")
        opts.append((
            {f"{comp_name}.weight_ih": ih, f"{comp_name}.weight_hh": hh,
             **bias},
            s,
            [f"{comp_name}: weight_ih/weight_hh tied by shape "
             f"([4H,{in_dim}] both) — resolved by name hints (score {s})"],
        ))
    return [sorted(opts, key=lambda o: -o[1])]


def _match_attention(comp_name: str, prefix: str, sub: Mapping[str, Shape],
                     a: int, enc: int, q: int):
    """Attention = three Linear sub-units under the prefix. The enc/dec
    biases are summed by the converter, so only the weight assignment can
    be ambiguous (when enc == q)."""
    units: dict[str, dict[str, Shape]] = {}
    for k, s in sub.items():
        leaf_path = _leaf(prefix, k)
        if "." not in leaf_path:
            raise FitError(
                f"attention component at {prefix!r} has a flat layout "
                f"(leaf {leaf_path!r}); expected three Linear submodules"
            )
        child = leaf_path.split(".")[0]
        child_prefix = child if prefix == "" else f"{prefix}.{child}"
        units.setdefault(child_prefix, {})[k] = s

    def unit_map(unit_prefix: str, canon: str) -> dict[str, str]:
        m = {}
        for k, s in units[unit_prefix].items():
            part = "weight" if len(s) == 2 else "bias"
            m[f"{comp_name}.{canon}.{part}"] = k
        return m

    full = next(u for u, ts in units.items()
                if any(s == (1, a) for s in ts.values()))
    rest = sorted(u for u in units if u != full)
    full_map = unit_map(full, "full_att")
    if enc != q:
        eu = next(u for u in rest
                  if any(s == (a, enc) for s in units[u].values()))
        du = next(u for u in rest if u != eu)
        return [[({**unit_map(eu, "encoder_att"), **unit_map(du, "decoder_att"),
                   **full_map}, 0, [])]]
    opts = []
    for eu, du in [(rest[0], rest[1]), (rest[1], rest[0])]:
        s = _hint_score(eu, "encoder_att") + _hint_score(du, "decoder_att")
        opts.append((
            {**unit_map(eu, "encoder_att"), **unit_map(du, "decoder_att"),
             **full_map},
            s,
            [f"{comp_name}: encoder_att/decoder_att tied by shape "
             f"([{a},{enc}] both) — resolved by name hints (score {s})"],
        ))
    return [sorted(opts, key=lambda o: -o[1])]


def _match_linear(comp_name: str, sub: Mapping[str, Shape]):
    m = {}
    for k, s in sub.items():
        m[f"{comp_name}.{'weight' if len(s) == 2 else 'bias'}"] = k
    return [[(m, 0, [])]]


def _match_copy_lstm(comp_name: str, prefix: str, sub: Mapping[str, Shape],
                     h: int, in_dim: int):
    lstm_sig = Counter([(4 * h, in_dim), (4 * h, h), (4 * h,), (4 * h,)])
    base_prefix = None
    for p in _all_prefixes(sub):
        if p == prefix or (prefix and not p.startswith(prefix + ".")):
            continue
        if Counter(_subtree(sub, p).values()) == lstm_sig:
            base_prefix = p
            break
    if base_prefix is None:
        raise FitError(
            f"copy-LSTM at {prefix!r}: no child subtree matches the base "
            f"LSTM signature {sorted(lstm_sig)}"
        )
    base_sub = _subtree(sub, base_prefix)
    options = _match_lstm(f"{comp_name}.base", base_prefix, base_sub,
                          h, in_dim)
    extras = {k: s for k, s in sub.items() if k not in base_sub}
    wrx = next(k for k, s in extras.items() if s == (h, in_dim))
    br = next(k for k, s in extras.items() if s == (h,))
    hh_keys = sorted(k for k, s in extras.items() if s == (h, h))
    fixed = {f"{comp_name}.weight_rx": wrx, f"{comp_name}.bias_r": br}
    opts = []
    for rh, rc in [(hh_keys[0], hh_keys[1]), (hh_keys[1], hh_keys[0])]:
        s = _hint_score(rh, "weight_rh") + _hint_score(rc, "weight_rc")
        opts.append((
            {**fixed, f"{comp_name}.weight_rh": rh,
             f"{comp_name}.weight_rc": rc},
            s,
            [f"{comp_name}: weight_rh/weight_rc tied by shape ([H,H] both) "
             f"— resolved by name hints (score {s})"],
        ))
    options.append(sorted(opts, key=lambda o: -o[1]))
    return options


def _match_component(comp: _Comp, prefix: str, sub: Mapping[str, Shape]):
    if comp.kind == "emb":
        (k,) = sub
        return [[({f"{comp.name}.weight"
                   if comp.name == "embedding" else comp.name: k}, 0, [])]]
    if comp.kind == "lstm":
        return _match_lstm(comp.name, prefix, sub, comp.dims["h"],
                           comp.dims["in_dim"])
    if comp.kind == "attention":
        return _match_attention(comp.name, prefix, sub, comp.dims["a"],
                                comp.dims["enc"], comp.dims["q"])
    if comp.kind == "linear":
        return _match_linear(comp.name, sub)
    if comp.kind == "copy_lstm":
        return _match_copy_lstm(comp.name, prefix, sub, comp.dims["h"],
                                comp.dims["in_dim"])
    raise AssertionError(comp.kind)


class FitError(ValueError):
    """The checkpoint's shapes cannot be reconciled with the architecture."""


# --------------------------------------------------------------- top level


def fit_translation(
    shapes: Mapping[str, Shape], arch: str, mcfg
) -> FitResult:
    """Fit canonical-key <- raw-key translations from shapes alone.

    ``shapes`` maps raw checkpoint keys to tensor shapes (use
    ``state_dict_shapes`` to build it from a state dict). Returns the
    hint-ranked best fit plus every other consistent assignment as
    alternates (capped); run ambiguous candidates through the parity gate
    to decide behaviorally — shapes cannot.
    """
    comps = expected_components(arch, mcfg)
    pool: dict[str, Shape] = {k: tuple(s) for k, s in shapes.items()}
    notes: list[str] = []

    # -- component-level assignment. Components with a unique candidate
    # subtree bind first (shrinking the pool sharpens later candidates);
    # components sharing identical candidate sets form tie groups whose
    # permutations are hint-ranked and branched over.
    assigned: dict[str, str] = {}  # comp name -> raw prefix (best fit)
    prefix_keys: dict[str, dict[str, Shape]] = {}  # exact keys per prefix
    tie_groups: list[tuple[list[_Comp], list[tuple[str, ...]]]] = []
    remaining = list(comps)
    while remaining:
        cand = {c.name: _component_candidates(c, pool) for c in remaining}
        for c in remaining:
            if not cand[c.name]:
                raise FitError(
                    f"no checkpoint subtree matches component {c.name!r} "
                    f"(expected shapes {sorted(_signatures(c)[0])}); "
                    f"wrong dims or architecture?"
                )
        uniq = [c for c in remaining if len(cand[c.name]) == 1]
        if uniq:
            for c in uniq:
                p = cand[c.name][0]
                if p in prefix_keys:
                    raise FitError(
                        f"components {c.name!r} and another both resolve "
                        f"to subtree {p!r}"
                    )
                assigned[c.name] = p
                prefix_keys[p] = _subtree(pool, p)
                for k in prefix_keys[p]:
                    pool.pop(k)
            remaining = [c for c in remaining if c not in uniq]
            continue
        first = remaining[0]
        tie = [c for c in remaining
               if set(cand[c.name]) == set(cand[first.name])]
        prefixes = cand[first.name]
        if len(tie) != len(prefixes):
            raise FitError(
                f"components {[c.name for c in tie]} share "
                f"{len(prefixes)} candidate subtrees {prefixes} — "
                f"count mismatch"
            )
        perms = sorted(
            itertools.permutations(prefixes),
            key=lambda pm: -sum(_hint_score(p, c.name)
                                for c, p in zip(tie, pm)),
        )
        tie_groups.append((tie, perms))
        notes.append(
            f"components {[c.name for c in tie]} tied by signature over "
            f"subtrees {list(prefixes)} — best permutation by name hints; "
            f"{len(perms) - 1} alternate assignment(s) recorded"
        )
        for c, p in zip(tie, perms[0]):
            assigned[c.name] = p
        for p in prefixes:
            prefix_keys[p] = _subtree(pool, p)
            for k in prefix_keys[p]:
                pool.pop(k)
        remaining = [c for c in remaining if c not in tie]

    # -- enumerate: (tie-group permutations) x (per-component leaf options)
    def comp_perm_score(assignment: Mapping[str, str]) -> int:
        return sum(_hint_score(assignment[c.name], c.name) for c in comps)

    base_assignments: list[dict[str, str]] = []
    perm_products = itertools.product(*[perms for _, perms in tie_groups]) \
        if tie_groups else iter([()])
    for combo in perm_products:
        a = dict(assigned)
        for (tie, _), pm in zip(tie_groups, combo):
            for c, p in zip(tie, pm):
                a[c.name] = p
        base_assignments.append(a)
        if len(base_assignments) >= _MAX_BRANCHES:
            notes.append(f"component permutations capped at {_MAX_BRANCHES}")
            break
    base_assignments.sort(key=lambda a: -comp_perm_score(a))

    ranked: list[tuple[dict[str, str], int, list[str]]] = []
    for a in base_assignments:
        options = []
        for c in comps:
            p = a[c.name]
            options.extend(_match_component(c, p, prefix_keys[p]))
        cscore = comp_perm_score(a)
        for trans, lscore, ns in _branch(options):
            # component-level hints dominate leaf-level ones
            ranked.append((trans, cscore * 1000 + lscore, ns))
            if len(ranked) >= _MAX_BRANCHES * 4:
                break
        if len(ranked) >= _MAX_BRANCHES * 4:
            notes.append(f"branch enumeration capped at {_MAX_BRANCHES * 4}")
            break
    ranked.sort(key=lambda r: -r[1])
    ranked = ranked[:_MAX_BRANCHES]
    best_trans, _, best_notes = ranked[0]
    used = set(best_trans.values())
    return FitResult(
        translation=best_trans,
        alternates=[r[0] for r in ranked[1:]],
        notes=notes + best_notes,
        unmatched_raw=sorted(k for k in shapes if k not in used),
    )


def infer_dims(shapes: Mapping[str, Shape], arch: str) -> dict[str, int]:
    """Recover (V, E, H, A, F) from checkpoint shapes alone, so the whole
    fit can run with zero configuration.

    Anchors, all structural (no names): every LSTM unit exposes H via its
    recurrent weight ([4H, H] next to [4H, in]); full_att's [1, A] gives
    A; the embedding is the lone 2D [V, E] whose first dim reappears as a
    Linear-with-bias out-dim at in-dim H (the fc head); EditNet's F falls
    out of the att-LSTM input width E+F+H (the widest LSTM input).
    """
    vals = list(shapes.values())
    two_d = [s for s in vals if len(s) == 2]
    # H: out-dims G that are 4x SOME 2D in-dim with matching [G, G/4].
    hs = {s[0] // 4 for s in two_d
          if s[0] % 4 == 0 and (s[0], s[0] // 4) in set(two_d)}
    # keep H values that look like real LSTM units (a 1D bias [4H] exists)
    one_d = {s[0] for s in vals if len(s) == 1}
    hs = {h for h in hs if 4 * h in one_d}
    if not hs:
        raise FitError("no LSTM-shaped unit found — cannot infer H")
    a_cands = {s[1] for s in two_d if s[0] == 1}
    if len(a_cands) != 1:
        raise FitError(f"cannot infer att_dim: [1, A] rows give {a_cands}")
    A = a_cands.pop()
    for H in sorted(hs, reverse=True):
        # fc: [V, H] with a [V] bias; embedding: [V, E] elsewhere.
        v_cands = {s[0] for s in two_d if s[1] == H and s[0] in one_d
                   and s[0] not in (A, H, 4 * H)}
        for V in sorted(v_cands, reverse=True):
            e_cands = [s[1] for s in two_d
                       if s[0] == V and s[1] != H] or [H]
            E = e_cands[0]
            dims = dict(vocab_size=V, emb_dim=E, hidden_dim=H, att_dim=A)
            widths = sorted(s[1] for s in two_d if s[0] == 4 * H)
            if arch == "editnet":
                F = widths[-1] - E - H
                if F <= 0:
                    continue
                dims["feat_dim"] = F
            else:
                # DCNet: a decoder wider than E+H betrays the visual
                # variant (its input concatenates the [*, F] context).
                extra = widths[-1] - E - H
                if extra > 0:
                    dims["feat_dim"] = extra
                    dims["dcnet_use_visual"] = True
            return dims
    raise FitError("could not infer (V, E, H) from the checkpoint shapes")


def state_dict_shapes(raw: Mapping[str, object]) -> dict[str, Shape]:
    """Float-tensor shapes of a (torch or numpy) state dict."""
    out = {}
    for k, v in raw.items():
        shape = getattr(v, "shape", None)
        if shape is None:
            continue
        dt = str(getattr(v, "dtype", ""))
        if "float" in dt or "bfloat16" in dt:
            out[k] = tuple(int(d) for d in shape)
    return out


def translate_state_dict(
    raw: Mapping[str, object], translation: Mapping[str, str]
) -> dict[str, object]:
    return {canon: raw[rk] for canon, rk in translation.items()}


def fit_params_from_state_dict(
    raw: Mapping[str, object],
    arch: str,
    mcfg,
    candidate: int = 0,
    device="cuda",
) -> tuple[object, FitResult]:
    """Fit the layout and convert in one step. ``candidate`` selects among
    the ranked fits (0 = best) for parity-gate sweeps over alternates.
    The parameters land on ``device``."""
    from captionkit_torch.convert.torch_import import params_from_state_dict

    fit = fit_translation(state_dict_shapes(raw), arch, mcfg)
    trans = fit.candidates[candidate]
    params = params_from_state_dict(
        translate_state_dict(raw, trans), arch, device=device
    )
    return params, fit
