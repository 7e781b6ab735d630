"""Recall@10 of the judged answers against the reference's exact 10 nearest
of the live f32 rows (the comparison's pass computes it)."""


def read(run):
    return run.facts.get("recall_at_10")
