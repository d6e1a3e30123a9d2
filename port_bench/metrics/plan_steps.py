"""plan_steps: the planner's loop bodies issued (RoundPlan.steps, summed
over its parts: bandwidth, bandwidth_redo, power), per round, over every
round of the traced window."""


def read(trace):
    rounds = trace["rounds"]
    return sum(r["plan_steps"] for r in rounds) / len(rounds) if rounds else None
