"""``{"op": "top_k", "k": 100, "by": "out"}``: the heaviest ``k`` vertices
by out- or in-degree over a fresh view."""
import torch

from d4m_bench import reference


def issue(view, q):
    """The answer on the host: ``(ids [k], counts [k])``."""
    ids, counts = view.top_k(int(q["k"]), q.get("by", "out"))
    return ids.cpu(), counts.cpu()


def count_wrong(stream, answers, q, traffic) -> int:
    """How many ``answers`` (``(groups of the epoch ingested before it,
    answer)``, sorted by the groups) are not a heaviest-k list of the
    degrees of that prefix of the epoch."""
    src, dst, vals = stream
    side = src if q.get("by", "out") == "out" else dst
    n_vertices = 1 << int(traffic["scale"])
    deg = torch.zeros(n_vertices, dtype=torch.float64, device=src.device)
    done = wrong = 0
    for offset, (ids, counts) in answers:
        while done < offset:
            deg += reference.out_degrees(side[done], vals[done], n_vertices)
            done += 1
        wrong += int(reference.top_k_wrong(deg, ids, counts, int(q["k"])))
    return wrong
