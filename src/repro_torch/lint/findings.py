"""Finding and suppression value types for ``repro_torch.lint``.

A :class:`Finding` is one rule violation anchored to (path, line) with a
stable identity key ``(rule, path, symbol)`` — line numbers are carried
for display but deliberately kept out of the identity, so a finding that
merely moves inside its function keeps matching its baseline entry.

Pragmas are read from real comments only: ``#`` comments of a Python
source, ``//`` and ``/* */`` comments of a CUDA source (``.cu`` /
``.cuh``).  A pragma quoted inside a string literal never counts.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

#: ``# repro-lint: ignore[RL101] reason`` / ``ignore[RL101,RL103] reason``
#: (``// repro-lint: ignore[RL106] reason`` in a CUDA source)
SUPPRESS_RE = re.compile(
    r"(?:#|//)\s*repro-lint:\s*ignore\[([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)\]"
    r"\s*(.*?)\s*$")

#: ``# repro-lint: legacy reason`` — file-level quarantine pragma.
LEGACY_RE = re.compile(r"(?:#|//)\s*repro-lint:\s*legacy\s+(.+?)\s*$")


@dataclass(frozen=True)
class Suppression:
    """One inline ``ignore[...]`` pragma (line it guards, codes, reason)."""
    line: int           # the source line the pragma applies to
    codes: tuple
    reason: str

    @property
    def valid(self) -> bool:
        return bool(self.reason.strip())


@dataclass
class Finding:
    rule: str                  # "RL101" ... "RL106" (or engine "RL00x")
    path: str                  # repo-relative, posix separators
    line: int
    symbol: str                # enclosing function/class qualname or "<module>"
    message: str
    tag: str = ""              # "legacy" for findings in quarantined files
    suppressed_by: Optional[Suppression] = field(default=None, repr=False)

    @property
    def key(self) -> tuple:
        """Baseline identity: stable across line-number churn."""
        return (self.rule, self.path, self.symbol)

    @property
    def suppressed(self) -> bool:
        return self.suppressed_by is not None and self.suppressed_by.valid

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "symbol": self.symbol, "message": self.message}
        if self.tag:
            d["tag"] = self.tag
        if self.suppressed_by is not None:
            d["suppressed"] = self.suppressed
            d["suppress_reason"] = self.suppressed_by.reason
        return d

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol != "<module>" else ""
        tag = f" ({self.tag})" if self.tag else ""
        return f"{loc}: {self.rule}{tag}{sym} {self.message}"


def _comment_tokens(text: str):
    """(line, col, comment_text) for every REAL comment token — pragmas
    quoted inside docstrings or string literals never count; ``col`` is 0
    for a comment on a line of its own, indented or not."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                col = tok.start[1]
                # a comment with nothing but blanks before it stands alone
                yield tok.start[0], col if tok.line[:col].strip() else 0, \
                    tok.string
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return


def _suppressions_from(comments, n_lines: int) -> dict:
    out = {}
    for lineno, col, comment in comments:
        m = SUPPRESS_RE.search(comment)
        if not m:
            continue
        codes = tuple(c.strip() for c in m.group(1).split(","))
        sup = Suppression(line=lineno, codes=codes, reason=m.group(2))
        out[lineno] = sup
        if col == 0 and lineno + 1 <= n_lines:
            # standalone comment: also guards the next line
            out.setdefault(lineno + 1, Suppression(
                line=lineno + 1, codes=codes, reason=m.group(2)))
    return out


def _legacy_from(comments, scan_lines: int) -> Optional[str]:
    for lineno, _col, comment in comments:
        if lineno > scan_lines:
            return None
        m = LEGACY_RE.match(comment)
        if m:
            return m.group(1)
    return None


def parse_suppressions(text: str) -> dict:
    """Map line number -> :class:`Suppression` for every inline pragma.

    A pragma on its own line (at any indent) guards the next line; a
    trailing pragma guards its own line.  Both entries are recorded so rules can anchor a
    finding at either the construct line or the pragma line.
    """
    return _suppressions_from(_comment_tokens(text), text.count("\n") + 1)


def parse_legacy_tag(text: str, scan_lines: int = 40) -> Optional[str]:
    """Return the quarantine reason if the file opens with a legacy pragma
    (a real comment within the first ``scan_lines`` lines)."""
    return _legacy_from(_comment_tokens(text), scan_lines)


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

def scan_c(text: str) -> Tuple[str, list]:
    """``(code, comments)`` of a C/C++/CUDA source.  ``code`` is ``text``
    with every comment and every string or character literal blanked to
    spaces (newlines kept, so lines and columns still match);
    ``comments`` is ``[(line, col, text)]`` for each real comment, ``col``
    0 when nothing but blanks precede it on its line."""
    out = list(text)
    comments = []
    i, n, line, line_start = 0, len(text), 1, 0

    def blank(a: int, b: int) -> None:
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "

    def col_of(pos: int) -> int:
        return 0 if not text[line_start:pos].strip() else pos - line_start

    while i < n:
        c = text[i]
        if c == "\n":
            line, line_start = line + 1, i + 1
            i += 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, col_of(i), text[i:j]))
            blank(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            comments.append((line, col_of(i), text[i:j]))
            blank(i, j)
            nl = text.count("\n", i, j)
            if nl:
                line += nl
                line_start = text.rfind("\n", i, j) + 1
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
            blank(i + 1, j - 1)
            i = j
        else:
            i += 1
    return "".join(out), comments


def parse_c_pragmas(text: str, scan_lines: int = 40
                    ) -> Tuple[str, dict, Optional[str]]:
    """``(code, suppressions, legacy)`` of a CUDA source: the blanked code
    (:func:`scan_c`), the ``// repro-lint: ignore[...]`` pragmas as
    :func:`parse_suppressions` maps them, and the ``// repro-lint:
    legacy`` quarantine reason, if any."""
    code, comments = scan_c(text)
    sups = _suppressions_from(comments, text.count("\n") + 1)
    return code, sups, _legacy_from(comments, scan_lines)
