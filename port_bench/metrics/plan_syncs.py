"""plan_syncs: the planner's host reads of the device (RoundPlan.syncs),
per round, over every round of the traced window."""


def read(trace):
    rounds = trace["rounds"]
    return sum(r["syncs"] for r in rounds) / len(rounds) if rounds else None
