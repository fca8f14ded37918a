"""Lock-step rounds of the per-move engine per outer iteration, over the
window's requests: the rounds the program counts (`timings["search_rounds"]`,
local search and perturbation, each round followed by one host sync; the
initial local search's included) over the chunks (one outer iteration
each).  Nothing where the program does not count them."""


def read(run):
    qs = [q for q in run.requests if q.timings.get("search_rounds") is not None]
    chunks = sum(q.chunks for q in qs)
    if not chunks:
        return None
    return sum(sum(q.timings["search_rounds"]) for q in qs) / chunks
