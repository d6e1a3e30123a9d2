"""The AIGC generators of the reference, one module a generator, found by
the name a configuration's `generator.reference` gives (`spec.
load_generator`). Each module gives:

* param_shapes(block): the parameter tree's leaf shapes, as a nested dict
  of tuples;
* make_params(block, seed, device): the weights drawn from the seed on
  `device`, in that tree;
* generate(block, params, labels, rng, run_seed, round_idx, device, *,
  prec, fault): images [n, 32, 32, 3] float32 for `labels`, drawing from
  `rng`, the round's random stream (the program's shared numpy Generator),
  where the program's generator draws from it, so that omega_a's batch
  draws that follow find it where the program left it; `fault` names a
  planted fault of the check's readings, one of FAULTS;
* FAULTS: the names of the module's planted faults, maybe none;
* step_flops(block): one image's forward FLOPs in one denoising step.
"""


def flat(tree, prefix="") -> dict:
    """{"a.b": leaf} of a nested dict, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def unflat(items: dict) -> dict:
    """The nested dict of {"a.b": leaf} (`flat` undone)."""
    out = {}
    for path, v in items.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
