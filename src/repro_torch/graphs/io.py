"""Edge-list IO + SVG export for computed layouts — the port's own copy of
the JAX package's ``graphs/io.py`` (pure numpy).

``load_edgelist`` is a chunked streaming reader: the old ``np.loadtxt``
path materialized the whole file as float64 text — the ingestion
bottleneck for 10M-edge inputs — while this one parses bounded line
chunks straight to int64 and understands the formats the paper's inputs
come in (``#``/``%`` comment lines, MatrixMarket ``.mtx`` headers with
1-based indices, trailing weight columns, empty files).
"""
from __future__ import annotations

import numpy as np

# number of data lines parsed per chunk — bounds peak memory at
# ~CHUNK_LINES · line length bytes regardless of file size
CHUNK_LINES = 1 << 20


def save_edgelist(path: str, edges: np.ndarray) -> None:
    np.savetxt(path, np.asarray(edges, dtype=np.int64), fmt="%d")


def _parse_chunk(lines: list[str]) -> np.ndarray:
    # first three tokens per line (split stops after 4 — columns past the
    # weight never get tokenized); float64 since weights/ids arrive as
    # text. Lines shorter than the chunk's widest row pad with weight 1.
    toks = [ln.split(None, 3)[:3] for ln in lines]
    width = max(len(t) for t in toks)
    if width > 1:
        toks = [t + ["1"] * (width - len(t)) for t in toks]
    return np.array(toks, dtype=np.float64)


def load_edgelist(path: str, weights: bool = False):
    """Stream an edge list (or MatrixMarket ``.mtx``) → (edges[m, 2], n).

    * ``#`` and ``%`` lines are comments (``%%MatrixMarket`` included);
    * a MatrixMarket body is detected by its ``%%MatrixMarket`` banner:
      the first data line is the ``rows cols nnz`` size line (skipped) and
      entries are 1-based (shifted to 0-based);
    * with ``weights=True`` the return is ``(edges, n, w)`` where ``w`` is
      the third column as float32 (1.0 where a line has no weight);
      otherwise the weight column is parsed and dropped;
    * an empty file yields ``(int64[0, 2], 0)`` without warnings.
    """
    is_mtx = False
    size_line_pending = False
    chunks: list[np.ndarray] = []
    n_header = 0
    buf: list[str] = []

    def flush():
        if buf:
            chunks.append(_parse_chunk(buf))
            buf.clear()

    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            if s[0] in "#%":
                if s.lower().startswith("%%matrixmarket"):
                    is_mtx = True
                    size_line_pending = True
                continue
            if size_line_pending:          # mtx "rows cols nnz" size line
                dims = s.split()
                n_header = max(int(dims[0]), int(dims[1]))
                size_line_pending = False
                continue
            buf.append(s)
            if len(buf) >= CHUNK_LINES:
                flush()
    flush()

    if not chunks:
        if weights:
            return np.zeros((0, 2), np.int64), n_header, np.zeros(0, np.float32)
        return np.zeros((0, 2), np.int64), n_header
    width = max(c.shape[1] for c in chunks)
    if width > 1:
        # normalize to one width: a chunk entirely of 2-column lines inside
        # a weighted file pads with weight 1
        chunks = [c if c.shape[1] == width else
                  np.hstack([c, np.ones((len(c), width - c.shape[1]))])
                  for c in chunks]
    raw = np.concatenate(chunks, axis=0)
    if raw.shape[1] == 1:
        # flat one-number-per-line files pair consecutive values, as the
        # old loadtxt(...).reshape(-1, 2) path did (odd counts still raise)
        raw = raw.reshape(-1, 2)
    e = raw[:, :2].astype(np.int64)
    w = (raw[:, 2].astype(np.float32) if raw.shape[1] > 2
         else np.ones(len(raw), np.float32))
    if is_mtx:
        e -= 1
    n = int(e.max()) + 1 if e.size else 0
    if weights:
        return e, max(n, n_header), w
    return e, max(n, n_header)


def save_svg(path: str, pos: np.ndarray, edges: np.ndarray,
             size: int = 1000, stroke: float = 0.6,
             max_edges: int = 200_000) -> None:
    """Minimal SVG writer so layouts can be inspected without matplotlib.

    Above ``max_edges`` the drawn edges are deterministically subsampled
    (evenly spaced in edge order) — a 10M-edge SVG is unusable and takes
    minutes to write; the cap is noted in the file's header comment.
    """
    pos = np.asarray(pos, dtype=np.float64)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    m_total = len(edges)
    if m_total > max_edges:
        keep = np.unique(np.linspace(0, m_total - 1, max_edges)
                         .astype(np.int64))
        edges = edges[keep]
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    P = (pos - lo) / span * (size - 20) + 10
    lines = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}">']
    if len(edges) < m_total:
        lines.append(f'<!-- edge cap: drew {len(edges)} of {m_total} edges '
                     f'(deterministic evenly-spaced subsample) -->')
    lines.append('<rect width="100%" height="100%" fill="white"/>')
    for (u, v) in edges:
        lines.append(
            f'<line x1="{P[u,0]:.1f}" y1="{P[u,1]:.1f}" '
            f'x2="{P[v,0]:.1f}" y2="{P[v,1]:.1f}" '
            f'stroke="black" stroke-width="{stroke}" stroke-opacity="0.5"/>')
    r = max(1.0, 3.0 - 0.0002 * len(pos))
    for p in P:
        lines.append(f'<circle cx="{p[0]:.1f}" cy="{p[1]:.1f}" r="{r:.1f}" fill="#c33"/>')
    lines.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines))
