"""GenFV core of the port (paper Sec. III-V), module for module the JAX
package's `repro.core`:

emd          EMD heterogeneity metric + weighted policy (eq. 3-4)
convergence  Theorem 1 bound
mobility     traffic-flow model, V2R holding time (eq. 24-27)
channel      OFDMA uplink rate/delay/energy (eq. 9-11)
gpu_model    GPU latency/power/energy (eq. 6-8)
selection    SUBP1 + the four baseline selection policies
bandwidth    SUBP2 Lagrange/KKT (Algorithm 1)
power        SUBP3 SCA (Algorithm 2)
generation   SUBP4 closed form (eq. 48)
planner      batched float64 SUBP2-4 BCD on the device (planner="torch")
two_scale    Algorithm 3 joint BCD loop -> RoundPlan

The host modules are numpy copies of the JAX package's and agree with it
bit for bit.
"""
from repro_torch.core import emd  # noqa: F401  (module; the emd() fn lives inside)
from repro_torch.core import convergence  # noqa: F401
from repro_torch.core.emd import (aggregate, data_weights, emd_many, kappas,
                                  label_histogram, lambda_bound, mean_emd)
from repro_torch.core.planner import bucket_size
from repro_torch.core.two_scale import RoundPlan, plan_round, plan_rounds_batched
