"""dlgrind for the port: the host-side static analysis of the JAX package's
analysis/ that applies to a PyTorch program (see __main__.py):

  * dlrace (race_lint.py, DLG301-306): the lock-discipline lint over the
    port's runtime/, apps/, parallel/multihost.py and parallel/control.py;
  * DLG206 (serving_d2h.py): the host syncs of a tensor on the per-token
    serving path;
  * DLG108/109: the baseline's hygiene.

Run `python -m distributed_llama_tpu_torch.analysis --check` (the gate).
Accepted findings live in analysis/baseline.json, each with a one-line
justification; suppress single lines with `# dlrace: ignore[RULE]`.
"""

from .findings import Finding  # noqa: F401
