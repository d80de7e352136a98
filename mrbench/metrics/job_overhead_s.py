"""Mean over the window's jobs of the job's wall seconds outside its
phases (stream, finalize, egress): run_job's own set-up and tear-down."""


def read(r):
    rest = [j.stats["wall_seconds"] - sum(j.stats["phase_seconds"].values())
            for j in r.done]
    return sum(rest) / len(rest) if rest else None
