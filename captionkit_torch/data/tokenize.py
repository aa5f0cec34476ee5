"""Tokenizers (a copy of ``captionkit.data.tokenize``).

The reference pipeline tokenizes captions twice:

1. Data prep: lowercase word-split of COCO captions (Karpathy JSON already
   ships tokens) — `simple_tokenize` here.
2. Metric eval: PTBTokenizer via a Stanford CoreNLP *Java subprocess*
   (SURVEY.md §3.4). We replace that with `ptb_tokenize`, a pure-Python
   reimplementation of the PTB tokenizer behaviour that pycocoevalcap
   relies on (CoreNLP `-preserveLines -lowerCase` tokenization, then
   dropping its PUNCTUATIONS list). It is host-side and decode-time only,
   so Python is the right tool; the optional Java jar adapter lives in
   captionkit.metrics.external.

Golden-tested against hand-recorded CoreNLP/PTB outputs in
tests/test_tokenize_golden.py; knowingly-accepted divergences are listed
in docs/PARITY.md (tokenizer section).
"""

from __future__ import annotations

import re

# The PUNCTUATIONS list used by pycocoevalcap's PTBTokenizer wrapper
# (SURVEY.md §3.4 ⟦cite: cococaption/tokenizer — mount empty⟧). Kept with
# the original casing ON PURPOSE: pycocoevalcap filters the already-
# lowercased token stream against this uppercase-bracket list, so
# "-lrb-"/"-rrb-" tokens survive in its output. We replicate that
# faithfully (metric parity beats prettiness).
_PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# PTB multi-word contractions (tokenizer.sed): split points are fixed.
_CONTRACTIONS = {
    "cannot": ("can", "not"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "wanna": ("wan", "na"),
    "gimme": ("gim", "me"),
    "lemme": ("lem", "me"),
    "d'ye": ("d'", "ye"),
    "'tis": ("'t", "is"),
    "'twas": ("'t", "was"),
    "more'n": ("more", "'n"),
}
# Clitics PTB splits off the host word: n't, 'll, 're, 've, 'd, 's, 'm.
_CLITIC_RE = re.compile(r"(n't|'ll|'re|'ve|'d|'s|'m)$")
# CoreNLP's abbreviation dictionary (PTBLexer kAbbrev — public PTB
# convention data, encoded by hand): these keep their trailing period as
# part of the token ("mr." tokenizes as mr., not mr + .), and since
# pycocoevalcap's PUNCTUATIONS filter only drops a bare ".", the period
# survives into the metric n-grams. Deliberately conservative: entries
# whose stem is also a common standalone English word that could simply
# end a sentence ("no.", "in.", "fig.", "gen.", "rep.", "mar.", "col.",
# "apt.") are NOT listed here — those go through the contextual
# heuristic below (_AMBIGUOUS_ABBREVS), which replicates the two
# CoreNLP cues available without a sentence model: a following number
# selects the abbreviation reading ("no. 5", "fig. 2", "apt. 3b"), and
# a capitalized title followed by a capitalized name does too
# ("Col. Mustard"); everything else takes the standalone-word reading
# ("a man holding a fig." -> fig + sentence-final period), which
# dominates in the caption domain. The residue — a mid-sentence
# lowercase abbreviation followed by a lowercase word — is genuinely
# undecidable without CoreNLP's sentence model (docs/PARITY.md
# divergence 3).
_ABBREVIATIONS = frozenset({
    # titles / honorifics
    "mr.", "mrs.", "ms.", "dr.", "prof.", "rev.", "hon.", "sr.", "jr.",
    "st.", "mt.", "messrs.", "mmes.",
    # military / government ranks
    "capt.", "sgt.", "lt.", "cmdr.", "adm.",
    "gov.", "sen.", "pres.", "supt.", "det.",
    # months
    "jan.", "feb.", "apr.", "jun.", "jul.", "aug.", "sep.",
    "sept.", "oct.", "nov.", "dec.",
    # corporate / institutional
    "co.", "corp.", "inc.", "ltd.", "bros.", "assn.", "dept.", "univ.",
    "ph.d.",
    # addresses
    "ave.", "blvd.", "rd.", "hwy.",
    # latin / misc
    "etc.", "vs.", "vol.", "approx.", "cf.", "al.", "seq.",
})
# Stems that are also common standalone English words: "X." is read as the
# abbreviation only when context says so (see _is_abbrev_reading); the
# default is the sentence-final standalone reading. "in." (inches) and
# "no." (number) want a following digit; the rank/title subset also
# accepts Capitalized-title + Capitalized-name.
_AMBIGUOUS_ABBREVS = frozenset({
    "no.", "in.", "fig.", "gen.", "rep.", "mar.", "col.", "apt.", "maj.",
})
_TITLE_AMBIGUOUS = frozenset({"gen.", "rep.", "col.", "maj."})


def _is_abbrev_reading(raw: str, nxt: str) -> bool:
    """Contextual disambiguation for _AMBIGUOUS_ABBREVS tokens.

    ``raw`` is the original-case token ("No.", "col."), ``nxt`` the
    original-case following whitespace token ("" at end of text). Returns
    True for the keep-the-period abbreviation reading.
    """
    if nxt[:1].isdigit():
        return True  # "no. 5", "fig. 2", "apt. 3b", "col. 4"
    low = raw.lower()
    if low in _TITLE_AMBIGUOUS and raw[:1].isupper() and nxt[:1].isupper():
        return True  # "Col. Mustard", "Gen. Lee", "Rep. Smith"
    return False
# Tokens kept whole: numbers/times with internal separators (1,000 / 3.5 /
# 10:30) and letter-period acronyms (u.s., e.g.) — CoreNLP keeps both.
_NUMBER_RE = re.compile(r"^\d(?:[\d.,:]*\d)?$")
_ABBREV_RE = re.compile(r"^(?:[a-z]\.){2,}$")
_ATOM_TOKENS = {
    "-lrb-", "-rrb-", "-lcb-", "-rcb-", "-lsb-", "-rsb-",
    "--", "-", "...", "``", "''", "`", "'",
}
_TRAILING_PUNCT_RE = re.compile(r"(\.\.\.|[.,!?;:]+|'+)$")
_INTERNAL_PUNCT_RE = re.compile(r"(\.\.\.|[.,!?;:]+)")


def simple_tokenize(text: str) -> list[str]:
    """Lowercase whitespace/punctuation word-split used at data-prep time."""
    text = text.lower().strip()
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    return [t for t in text.split() if t]


def _split_token(tok: str) -> list[str]:
    if not tok:
        return []
    if tok in _ATOM_TOKENS:
        return [tok]
    if tok in _CONTRACTIONS:
        return list(_CONTRACTIONS[tok])
    if tok in _ABBREVIATIONS:
        return [tok]
    if _NUMBER_RE.match(tok) or _ABBREV_RE.match(tok):
        return [tok]
    if _CLITIC_RE.fullmatch(tok):  # a bare clitic has no host to split from
        return [tok]
    # Opening single quote -> ` (PTB prints openers as backticks).
    if tok[0] == "'":
        return ["`"] + _split_token(tok[1:])
    # Peel one trailing punctuation run (sentence-final period, commas,
    # plural possessive / closing quote) and recurse on the head — this
    # lets "3.5." resolve to ["3.5", "."] and "don't," to [do, n't, ,].
    # Runs split to single tokens ("!!!" -> "!","!","!") so the
    # PUNCTUATIONS filter removes them all.
    m = _TRAILING_PUNCT_RE.search(tok)
    if m and m.start() > 0:
        head, tail = tok[: m.start()], m.group(0)
        # Abbreviation followed by more punctuation ("mr.," / "etc.!" /
        # "mr..."): the dictionary period stays with the head, the rest
        # peels off (an ellipsis loses its first dot: "mr..." -> mr. . .).
        if tail[0] == "." and head + "." in _ABBREVIATIONS:
            head, tail = head + ".", tail[1:]
            if not tail:
                return [head]
        tails = [tail] if tail == "..." else (
            ["'"] if set(tail) == {"'"} else list(tail)
        )
        return _split_token(head) + tails
    # Remaining internal punctuation (e.g. "a,b" typos): split it out.
    parts = [p for p in _INTERNAL_PUNCT_RE.split(tok) if p]
    if len(parts) > 1:
        out: list[str] = []
        for p in parts:
            out.extend([p] if _INTERNAL_PUNCT_RE.fullmatch(p)
                       else _split_token(p))
        return out
    m = _CLITIC_RE.search(tok)
    if m and m.start() > 0:
        return [tok[: m.start()], tok[m.start():]]
    return [tok]


def ptb_split(text: str) -> list[str]:
    """Full PTB token stream (lowercased), before punctuation removal.

    Case is preserved until AFTER the per-token context decisions —
    CoreNLP with ``-lowerCase`` also tokenizes the original text and
    lowercases the output, so capitalization cues (sentence starts,
    "Col. Mustard") are available to its abbreviation handling and must
    be available to ours.
    """
    t = " " + text.strip() + " "
    t = (
        t.replace("(", " -lrb- ").replace(")", " -rrb- ")
        .replace("{", " -lcb- ").replace("}", " -rcb- ")
        .replace("[", " -lsb- ").replace("]", " -rsb- ")
    )
    # Double quotes: opener after whitespace -> ``, closer -> ''.
    t = re.sub(r'(?<=\s)"', " `` ", t)
    t = t.replace('"', " '' ")
    t = t.replace("--", " -- ")
    raws = t.split()
    out: list[str] = []
    for i, raw in enumerate(raws):
        low = raw.lower()
        if low in _AMBIGUOUS_ABBREVS:
            nxt = raws[i + 1] if i + 1 < len(raws) else ""
            if _is_abbrev_reading(raw, nxt):
                out.append(low)
                continue
        out.extend(_split_token(low))
    return out


def ptb_tokenize(text: str) -> list[str]:
    """PTB-style tokenization matching the cococaption eval path: CoreNLP
    lowercased tokenization followed by dropping pycocoevalcap's
    PUNCTUATIONS tokens."""
    return [p for p in ptb_split(text) if p not in _PUNCTUATIONS]


def ptb_tokenize_to_string(text: str) -> str:
    return " ".join(ptb_tokenize(text))
