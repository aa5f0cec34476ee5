"""Optional Java-jar metric adapters, METEOR 1.5 and SPICE (a copy of
``captionkit.metrics.external``).

They shell out to the JVM with the cococaption subprocess protocols, and
only when the jars and a JVM exist on the host; nothing in decoding or
scoring depends on them, and nothing is downloaded.

Jar discovery: $CAPTIONKIT_METEOR_JAR / $CAPTIONKIT_SPICE_JAR, else
``third_party/meteor/meteor-1.5.jar`` / ``third_party/spice/spice-1.0.jar``
under the working directory, resolved at call time. $CAPTIONKIT_JAVA overrides the
JVM binary.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from collections.abc import Mapping, Sequence
from typing import Callable


def _find(paths: list[str]) -> str | None:
    for p in paths:
        if p and os.path.exists(p):
            return p
    return None


def _meteor_jar() -> str | None:
    return _find([
        os.environ.get("CAPTIONKIT_METEOR_JAR", ""),
        "third_party/meteor/meteor-1.5.jar",
    ])


def _spice_jar() -> str | None:
    return _find([
        os.environ.get("CAPTIONKIT_SPICE_JAR", ""),
        "third_party/spice/spice-1.0.jar",
    ])


def _java() -> str | None:
    return os.environ.get("CAPTIONKIT_JAVA") or shutil.which("java")


def meteor_available() -> bool:
    return _java() is not None and _meteor_jar() is not None


def spice_available() -> bool:
    return _java() is not None and _spice_jar() is not None


def meteor_score(
    references: Mapping[object, Sequence[str]],
    hypotheses: Mapping[object, str],
) -> float:
    """METEOR 1.5 via the jar's stdio protocol, mirroring pycocoevalcap's
    Meteor wrapper: one SCORE line per image read back
    IMMEDIATELY (interleaved, so pipe buffers never fill), then a single
    EVAL line carrying every per-image stats blob; the jar replies with one
    score per image followed by the stats-aggregated corpus score."""
    jar, java = _meteor_jar(), _java()
    if jar is None or java is None:
        raise RuntimeError("METEOR jar/JVM not available on this host")
    ids = sorted(hypotheses.keys(), key=str)
    proc = subprocess.Popen(
        [java, "-jar", jar, "-", "-", "-stdio", "-l", "en", "-norm"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
    )
    try:
        stats = []
        for i in ids:
            # refs are ' ||| '-separated fields of the SCORE line, same as
            # the hypothesis (pycocoevalcap Meteor._stat wire format).
            refs = " ||| ".join(
                r.replace("|||", " ") for r in references[i]
            )
            hyp = hypotheses[i].replace("|||", " ")
            proc.stdin.write(f"SCORE ||| {refs} ||| {hyp}\n")
            proc.stdin.flush()
            stats.append(proc.stdout.readline().strip())
        proc.stdin.write("EVAL ||| " + " ||| ".join(stats) + "\n")
        proc.stdin.flush()
        for _ in ids:
            proc.stdout.readline()  # per-image scores
        final = proc.stdout.readline().strip()  # aggregated corpus METEOR
        return float(final)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)


def spice_score(
    references: Mapping[object, Sequence[str]],
    hypotheses: Mapping[object, str],
) -> float:
    """SPICE via the jar's temp-JSON protocol."""
    jar, java = _spice_jar(), _java()
    if jar is None or java is None:
        raise RuntimeError("SPICE jar/JVM not available on this host")
    import json

    ids = sorted(hypotheses.keys(), key=str)
    payload = [
        {"image_id": str(i), "test": hypotheses[i],
         "refs": list(references[i])}
        for i in ids
    ]
    with tempfile.TemporaryDirectory() as td:
        inp = os.path.join(td, "in.json")
        outp = os.path.join(td, "out.json")
        with open(inp, "w") as f:
            json.dump(payload, f)
        subprocess.run(
            [java, "-Xmx8G", "-jar", jar, inp, "-out", outp,
             "-subset", "-silent"],
            check=True, timeout=1800,
        )
        with open(outp) as f:
            results = json.load(f)
    vals = [r["scores"]["All"]["f"] for r in results]
    return sum(vals) / max(len(vals), 1)


def available_scorers() -> dict[str, Callable]:
    out: dict[str, Callable] = {}
    if meteor_available():
        out["METEOR"] = meteor_score
    if spice_available():
        out["SPICE"] = spice_score
    return out
