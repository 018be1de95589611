"""Captioning metrics: tokenizer, CIDEr, METEOR — pure python, jar-free.

The reference's metric stack shells out to two Java jars (PTBTokenizer via
stanford-corenlp, METEOR 1.5 — `test/dvc/metrics/`, SURVEY.md §2.9) that
are large binary blobs. This module reimplements the stack self-contained:

- :func:`ptb_tokenize` — the PTBTokenizer contract as used by
  pycocoevalcap: lowercase, PTB contraction/possessive/assimilation
  splits, quote/bracket/dash normalization, then the fork's punctuation
  filter (incl. its lowercase-bracket survival quirk). Not a full clone
  of the corenlp lexer (no sentence-final-abbreviation logic, no rare
  REDAUX entries); :class:`PTBTokenizerJar` restores jar-exactness when
  $CORENLP_JAR is set;
- :class:`Cider` — faithful reimplementation of the published CIDEr-D-less
  CIDEr algorithm (TF-IDF n-gram cosine, n=1..4, sigma=6, ×10) matching
  pycocoevalcap's `cider_scorer.py` semantics;
- :class:`Meteor` — METEOR with exact + Porter-stem matching stages,
  cross-checked against nltk's independent implementation (same classic
  parameters α=0.9, β=3, γ=0.5; see tests). NOT a bit-exact clone of
  meteor-1.5.jar (which adds WordNet/paraphrase matchers and tuned
  weights) — that drift is unquantifiable without the jar;
- :class:`MeteorJar` — the jar-subprocess backend speaking the
  reference's exact stdio protocol; :func:`make_meteor` selects it
  automatically when $METEOR_JAR points at meteor-1.5.jar, restoring
  jar-exact YouCook2 METEOR / SODA_c numbers.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

# ---------------------------------------------------------------------------
# PTB tokenization (stanford-corenlp PTBTokenizer `-preserveLines -lowerCase`
# as invoked by the pycocoevalcap fork, `test/dvc/metrics/ptbtokenizer.py:48-50`)
# followed by the fork's punctuation filter (`ptbtokenizer.py:89-90`).
#
# Faithfulness notes:
# - contractions split PTB-style: "don't"→"do n't" (incl. "can't"→"ca n't"),
#   "it's"→"it 's", "'s/'m/'re/'ve/'ll/'d" become separate tokens that
#   SURVIVE the punctuation filter;
# - assimilations split: cannot→"can not", gonna→"gon na", 'tis→"'t is" …;
# - plural possessive "dogs'" → "dogs '" (the "'" is then filtered);
# - brackets normalize to -lrb-/-rrb-/… — LOWERCASE, because the jar is run
#   with -lowerCase; the fork's filter list has them UPPERCASE, so bracket
#   tokens survive into the metrics. A deliberate quirk reproduction;
# - quotes normalize to ``/''/` /' (all filtered), unicode quotes/dashes
#   normalized first;
# - numbers keep internal [.,:] ("1,000", "3.5", "2:30"), "$"/"%" are
#   standalone surviving tokens, intra-word hyphens are kept.
# ---------------------------------------------------------------------------

_ASSIMILATIONS = {
    "cannot": ("can", "not"), "gonna": ("gon", "na"), "gotta": ("got", "ta"),
    "lemme": ("lem", "me"), "gimme": ("gim", "me"), "wanna": ("wan", "na"),
    "'tis": ("'t", "is"), "'twas": ("'t", "was"),
}
# leading-apostrophe words the PTB lexer keeps whole (REDAUX set)
_APOS_WORDS = {"'em", "'til", "'cause", "'ere", "'n'", "'n"}
_CONTRACTION_SUFFIXES = ("'s", "'m", "'re", "'ve", "'ll", "'d")

_BRACKETS = {"(": "-lrb-", ")": "-rrb-", "[": "-lsb-", "]": "-rsb-",
             "{": "-lcb-", "}": "-rcb-"}

_UNICODE_NORM = {
    "’": "'", "‘": "'", "“": '"', "”": '"',
    "—": "--", "–": "--", "…": "...",
}

_PTB_SCAN = re.compile(
    r"""(?:[a-z]\.){2,}[a-z]?         # abbreviations: u.s., p.m., e.g.
      | \d+(?:[.,:]\d+)*[a-z]*(?:-[a-z0-9]+)*   # 1,000 3.5 2:30 1990s 4-year-old
      | '?[a-z][a-z0-9]*(?:['-][a-z0-9]+)*   # words: don't o'clock mp3 'em
      | \.\.\.
      | --
      | \S                            # any other single character
    """,
    re.X,
)


def _split_word(tok: str) -> List[str]:
    """PTB post-splits on one scanned word token (already lowercase)."""
    if tok in _ASSIMILATIONS:
        return list(_ASSIMILATIONS[tok])
    if tok.startswith("'") and tok not in _APOS_WORDS:
        # unknown leading apostrophe = opening quote, not part of the word
        return ["'"] + (_split_word(tok[1:]) if len(tok) > 1 else [])
    if tok.endswith("n't") and len(tok) > 3:
        return [tok[:-3], "n't"]
    for suf in _CONTRACTION_SUFFIXES:
        if tok.endswith(suf) and len(tok) > len(suf):
            head = tok[: -len(suf)]
            # o'clock-style internal apostrophes are not contractions of
            # these suffixes when the head itself ends with an apostrophe
            if not head.endswith("'"):
                return [head, suf]
    return [tok]


def ptb_tokenize(text: str) -> str:
    for src, dst in _UNICODE_NORM.items():
        text = text.replace(src, dst)
    text = text.replace("\n", " ").lower()
    toks: List[str] = []
    for tok in _PTB_SCAN.findall(text):
        if tok in _BRACKETS:
            toks.append(_BRACKETS[tok])
        elif tok == '"':
            toks.append("''")
        elif tok[0].isalpha() or tok.startswith("'"):
            toks.extend(_split_word(tok))
        else:
            toks.append(tok)
    return " ".join(t for t in toks if t not in PUNCTUATIONS)


def ptb_tokenize_batch(texts: Sequence[str]) -> List[str]:
    return [ptb_tokenize(t) for t in texts]


class PTBTokenizerJar:
    """stanford-corenlp PTBTokenizer subprocess backend — the exact CLI
    contract of the reference (`test/dvc/metrics/ptbtokenizer.py:48-81`):
    one java invocation per batch, `-preserveLines -lowerCase`, sentences
    joined by newlines through a temp file, then the fork's punctuation
    filter. Select it by pointing $CORENLP_JAR at stanford-corenlp-*.jar."""

    def __init__(self, jar_path: str, java_bin: str = None):
        import os

        self.jar = jar_path
        self.java = java_bin or os.environ.get("JRE_BIN_JAVA", "java")
        if not os.path.exists(jar_path):
            raise FileNotFoundError(jar_path)

    def __call__(self, texts: Sequence[str]) -> List[str]:
        import os
        import subprocess
        import tempfile

        # one input LINE per caption: normalize every unicode/line
        # separator the jar's -preserveLines would split on, and keep
        # empty captions as empty lines (a dropped line would silently
        # misalign every caption after it)
        def one_line(t: str) -> str:
            for sep in ("\r\n", "\r", "\n", " ", " ", "\x0b", "\x0c"):
                t = t.replace(sep, " ")
            return t

        sentences = "\n".join(one_line(t) for t in texts)
        fd, tmp = tempfile.mkstemp()
        try:
            with os.fdopen(fd, "w") as f:
                f.write(sentences)
            out = subprocess.run(
                [self.java, "-cp", self.jar,
                 "edu.stanford.nlp.process.PTBTokenizer",
                 "-preserveLines", "-lowerCase", tmp],
                stdout=subprocess.PIPE, check=True,
            ).stdout.decode()
        finally:
            os.remove(tmp)
        lines = out.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # trailing newline of the jar's last line
        if len(lines) != len(texts):
            raise RuntimeError(
                f"PTBTokenizer returned {len(lines)} lines for "
                f"{len(texts)} captions — output misaligned; refusing to "
                "score against shifted tokenizations"
            )
        return [
            " ".join(w for w in line.rstrip().split(" ") if w not in PUNCTUATIONS)
            for line in lines
        ]


def make_ptb_tokenizer(jar_path: str = None):
    """Batch tokenizer factory: the corenlp jar when available
    ($CORENLP_JAR or explicit path), else the pure-python contract."""
    import os

    jar = jar_path or os.environ.get("CORENLP_JAR")
    if jar and os.path.exists(jar):
        return PTBTokenizerJar(jar)
    return ptb_tokenize_batch


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------


def _ngrams(words: Sequence[str], n_max: int = 4) -> List[Counter]:
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(tuple(words[i : i + n]) for i in range(len(words) - n + 1)))
    return out


class Cider:
    """Corpus CIDEr. compute_score(gts, res) -> (corpus_score, per_image).

    gts/res: dict image_id -> list of caption strings (res has exactly 1).
    """

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        keys = list(gts.keys())
        crefs = [[_ngrams(self._words(c), self.n) for c in self._caps(gts[k])] for k in keys]
        ctest = [_ngrams(self._words(self._caps(res[k])[0]), self.n) for k in keys]

        # document frequency over reference sets
        doc_freq: Counter = Counter()
        for refs in crefs:
            seen = set(ng for ref in refs for n_idx in range(self.n) for ng in ref[n_idx])
            doc_freq.update(seen)
        log_n_docs = np.log(max(len(crefs), 1))

        def counts2vec(cnts: List[Counter]):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for n_idx in range(self.n):
                for ng, tf in cnts[n_idx].items():
                    idf = log_n_docs - np.log(max(1.0, doc_freq[ng]))
                    vec[n_idx][ng] = float(tf) * idf
                    norm[n_idx] += vec[n_idx][ng] ** 2
                    if n_idx == 0:
                        length += tf
                norm[n_idx] = np.sqrt(norm[n_idx])
            return vec, norm, length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self.n)
            for n_idx in range(self.n):
                for ng, w in vh[n_idx].items():
                    val[n_idx] += min(w, vr[n_idx][ng]) * vr[n_idx][ng]
                if nh[n_idx] != 0 and nr[n_idx] != 0:
                    val[n_idx] /= nh[n_idx] * nr[n_idx]
                val[n_idx] *= np.exp(-(delta**2) / (2 * self.sigma**2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vt, nt, lt = counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                score += sim(vt, vr, nt, nr, lt, lr)
            score_avg = np.mean(score / max(len(refs), 1)) * 10.0
            scores.append(score_avg)
        scores = np.array(scores)
        return float(scores.mean()) if len(scores) else 0.0, scores

    @staticmethod
    def _caps(v) -> List[str]:
        return [c["caption"] if isinstance(c, dict) else c for c in v]

    @staticmethod
    def _words(c: str) -> List[str]:
        return c.split()


# ---------------------------------------------------------------------------
# Porter stemmer (classic 1980 algorithm)
# ---------------------------------------------------------------------------

_V = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _V:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    forms = "".join("c" if _is_cons(stem, i) else "v" for i in range(len(stem)))
    return len(re.findall("vc", forms))


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    return (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
        if w.endswith(suf):
            w = w[: len(w) - len(suf)] + rep
            break
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w, flag = w[:-2], True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: len(w) - len(suf)]) > 0:
                w = w[: len(w) - len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: len(w) - len(suf)]) > 0:
                w = w[: len(w) - len(suf)] + rep
            break
    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    pass
                else:
                    w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR (exact + stem stages, METEOR-1.5 scoring model)
# ---------------------------------------------------------------------------

# Common English function words (articles, prepositions, conjunctions,
# pronouns, auxiliaries). METEOR 1.5 derives its list from corpus
# frequency (relative freq > 1e-3); this hand-written list covers the
# same closed-class vocabulary but is not byte-identical to the jar's
# `function.words` file.
FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every no
    i you he she it we they me him her us them my your his its our their
    mine yours hers ours theirs myself yourself himself herself itself
    ourselves themselves who whom whose which what
    in on at by for with about against between into through during before
    after above below to from up down out off over under again further of
    and or but nor so yet as if than because while where when why how
    be am is are was were been being have has had having do does did doing
    will would shall should may might must can could
    not only just also very too then there here all both few more most
    other such own same s t don now""".split()
)


class Meteor:
    """Pure-python METEOR with exact + Porter-stem matchers: weighted
    precision/recall with optional content/function-word discounting
    (delta), matcher weights, and the fragmentation penalty.

    Defaults are the CLASSIC, independently verifiable parameters
    (alpha=0.9, beta=3, gamma=0.5, no word-class discrimination — the
    Lavie-Agarwal formulation that nltk's meteor_score also implements,
    so behavior is cross-checkable offline). The meteor-1.5 ranking-task
    parameterization is available as :meth:`meteor15`, but its absolute
    scale CANNOT be validated in this environment (no jar, no java), so
    it is not the default.

    vs meteor-1.5.jar: the synonym (WordNet) and paraphrase-table
    matchers are absent and the function-word list is a clean-room
    equivalent — scores are comparable, not bit-identical, and the drift
    is UNQUANTIFIED here. For jar-exact protocol numbers provide the jar:
    :class:`MeteorJar` speaks the reference's exact stdio contract
    (`test/dvc/metrics/meteor.py:39-65`) and is preferred automatically
    by :func:`make_meteor` when $METEOR_JAR points at a jar.

    compute_score mirrors the pycocoevalcap interface:
    (corpus_score, per_image_scores)."""

    def __init__(self, alpha: float = 0.9, beta: float = 3.0,
                 gamma: float = 0.5, delta: float = 0.5,
                 w_exact: float = 1.0, w_stem: float = 1.0):
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.w_exact, self.w_stem = w_exact, w_stem

    @classmethod
    def meteor15(cls) -> "Meteor":
        """The meteor-1.5 English ranking-task tuning (alpha=0.85,
        beta=0.2, gamma=0.6, delta=0.75, stem weight 0.6). Absolute
        scores sit on a different scale than the classic parameters
        (e.g. an exact match incurs a substantial fragmentation penalty:
        gamma*(1/m)^beta)."""
        return cls(alpha=0.85, beta=0.2, gamma=0.6, delta=0.75,
                   w_exact=1.0, w_stem=0.6)

    def _align(self, hyp: List[str], ref: List[str]):
        """Greedy two-stage alignment → list of (hyp_i, ref_j, matcher_w)."""
        match_to = [-1] * len(hyp)  # hyp idx -> ref idx
        match_w = [0.0] * len(hyp)
        used = [False] * len(ref)
        # stage 1: exact
        for i, hw in enumerate(hyp):
            for j, rw in enumerate(ref):
                if not used[j] and hw == rw:
                    match_to[i], match_w[i], used[j] = j, self.w_exact, True
                    break
        # stage 2: stem
        hyp_stem = [porter_stem(w) for w in hyp]
        ref_stem = [porter_stem(w) for w in ref]
        for i in range(len(hyp)):
            if match_to[i] >= 0:
                continue
            for j in range(len(ref)):
                if not used[j] and hyp_stem[i] == ref_stem[j]:
                    match_to[i], match_w[i], used[j] = j, self.w_stem, True
                    break
        return match_to, match_w

    @staticmethod
    def _chunks(match_to: List[int]) -> int:
        """Maximal runs of adjacent matches in both strings."""
        chunks = 0
        prev = None
        for m in match_to:
            if m < 0:
                prev = None
                continue
            if prev is None or m != prev + 1:
                chunks += 1
            prev = m
        return chunks

    def _word_weight(self, w: str) -> float:
        return self.delta if w not in FUNCTION_WORDS else 1.0 - self.delta

    def _score_pair(self, hyp: str, ref: str) -> float:
        h, r = hyp.split(), ref.split()
        if not h or not r:
            return 0.0
        match_to, match_w = self._align(h, r)
        m = sum(1 for x in match_to if x >= 0)
        if m == 0:
            return 0.0
        # delta-weighted precision / recall (content words count delta,
        # function words 1-delta; matcher weight scales each match)
        p_num = sum(
            w * self._word_weight(h[i])
            for i, (j, w) in enumerate(zip(match_to, match_w)) if j >= 0
        )
        r_num = sum(
            w * self._word_weight(r[j])
            for j, w in ((match_to[i], match_w[i]) for i in range(len(h)))
            if j >= 0
        )
        p_den = sum(self._word_weight(w) for w in h)
        r_den = sum(self._word_weight(w) for w in r)
        if p_num == 0 or r_num == 0:
            return 0.0
        p = p_num / p_den
        rec = r_num / r_den
        fmean = p * rec / (self.alpha * p + (1 - self.alpha) * rec)
        penalty = self.gamma * (self._chunks(match_to) / m) ** self.beta
        return fmean * (1 - penalty)

    def _score_entry(self, hyp: str, refs: List[str]) -> float:
        return max(self._score_pair(hyp, r) for r in refs)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = []
        for k in gts:
            hyp = Cider._caps(res[k])[0]
            refs = Cider._caps(gts[k])
            scores.append(self._score_entry(hyp, refs))
        scores = np.array(scores)
        return float(scores.mean()) if len(scores) else 0.0, scores


class MeteorJar:
    """meteor-1.5.jar subprocess backend: the reference's exact stdio
    protocol (`test/dvc/metrics/meteor.py:39-65`) — one persistent
    ``java -jar meteor-1.5.jar - - -stdio -l en -norm`` process, SCORE
    lines producing stat strings, one EVAL line producing per-image
    scores + the aggregate. Use when the jar is available to get
    bit-exact protocol numbers; ``cmd`` is overridable for testing."""

    def __init__(self, jar_path: str = None, java_bin: str = "java",
                 cmd: List[str] = None):
        import subprocess
        import threading

        if cmd is None:
            import os

            jar = jar_path or os.environ.get("METEOR_JAR", "meteor-1.5.jar")
            assert os.path.exists(jar), f"meteor jar not found: {jar}"
            cmd = [java_bin, "-jar", "-Xmx2G", jar, "-", "-", "-stdio",
                   "-l", "en", "-norm"]
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE
        )
        self.lock = threading.Lock()

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        with self.lock:
            assert sorted(gts.keys()) == sorted(res.keys())
            # per-image scores are returned in the CALLER'S key order.
            # The reference sorts keys as STRINGS (`meteor.py:53`), which
            # silently permutes rows once numeric keys reach '10' — SODA's
            # score matrix is consumed positionally, so that ordering
            # scrambles alignments for videos with >=11 captions. Insertion
            # order keeps jar and pure-python backends consistent.
            img_ids = list(gts.keys())
            stats = []
            for k in img_ids:
                hyp = Cider._caps(res[k])[0].replace("|||", "").replace("  ", " ")
                refs = Cider._caps(gts[k])
                line = " ||| ".join(("SCORE", " ||| ".join(refs), hyp))
                self.proc.stdin.write((line + "\n").encode())
                self.proc.stdin.flush()
                stats.append(self.proc.stdout.readline().decode().strip())
            eval_line = "EVAL ||| " + " ||| ".join(stats)
            self.proc.stdin.write((eval_line + "\n").encode())
            self.proc.stdin.flush()
            scores = [
                float(self.proc.stdout.readline().decode()) for _ in img_ids
            ]
            aggregate = float(self.proc.stdout.readline().decode())
        return aggregate, np.asarray(scores)

    def _score_entry(self, hyp: str, refs: List[str]) -> float:
        _, per = self.compute_score({0: refs}, {0: [hyp]})
        return float(per[0])

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.terminate()
        except Exception:
            pass


def make_meteor(jar_path: str = None) -> object:
    """Prefer the jar backend when a jar is present (explicit path or
    $METEOR_JAR); otherwise the pure-python scorer."""
    import os

    jar = jar_path or os.environ.get("METEOR_JAR")
    if jar and os.path.exists(jar):
        return MeteorJar(jar_path=jar)
    return Meteor()
