"""Rule ``dtype_leak`` — no 64-bit leaves in the simulator carry and no
64-bit float inside the recorded chunk (the port's copy of
`wittgenstein_tpu/analysis/rules_dtype.py`).

The reference keeps all simulation time in int milliseconds
(Network.java's int-ms invariant); the contract is int32 time and
32-bit-or-narrower state everywhere.  A float64/int64 leaf sneaking in
doubles carry residency and desyncs the counter-based PRNG draws
between the port and the JAX package, so it is an error.

Checks, per target:
  * every leaf of the chunk's input and output carry has an allowed
    dtype (a 64-bit one is an error, any other a warning);
  * ``net.time`` is exactly int32;
  * no float64 output among the recorded ops, except at sites the
    budget file's ``dtype_leak.allow`` names as
    ``"relpath::function::float64"`` (``*`` for every function of the
    module: the port's exact float32 emulation, `ops/fmath.py`,
    computes in float64 on purpose — ETHPoW's mining threshold and the
    speed models' erfinv).

Unlike the JAX program, the port's step computes in int64 where it
emulates uint32 hashing and where PyTorch indexes: int64 intermediates
are reported as the info count ``int64_ops``, not as errors.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree

from .framework import Finding, Rule, register_rule, parse_allow

ALLOWED = {"int32", "uint32", "int16", "uint16", "int8", "uint8",
           "bool", "float32", "bfloat16", "float16"}


def check_carry_leaves(carry, name, rule_name, what="carry") -> list:
    findings = []
    for leaf in pytree.tree_leaves(carry):
        dt = str(getattr(leaf, "dtype", "")).replace("torch.", "")
        if dt and dt not in ALLOWED:
            sev = "error" if dt.endswith("64") else "warning"
            findings.append(Finding(
                rule=rule_name, target=name, severity=sev,
                message=f"{what} leaf with dtype {dt} (shape "
                        f"{tuple(getattr(leaf, 'shape', ()))}); allowed: "
                        f"{sorted(ALLOWED)}"))
    return findings


def float64_sites(recorder, allow=()) -> dict:
    """``site -> count`` of recorded float64 outputs outside `allow`."""
    out: dict = {}
    for op in recorder.ops:
        if "float64" in op.dtypes:
            site = op.site or "<outside the port>"
            module = site.split("::")[0]
            if f"{site}::float64" not in allow and \
                    f"{module}::*::float64" not in allow:
                out[site] = out.get(site, 0) + 1
    return out


@register_rule
class DtypeLeakRule(Rule):
    name = "dtype_leak"
    scope = "protocol"

    def run(self, target, budget, allow=None):
        if allow is None:
            from .framework import load_budgets
            allow = parse_allow(load_budgets().get(self.name, {}))
        findings = check_carry_leaves(target.args, target.name, self.name)
        findings += check_carry_leaves(target.out, target.name, self.name,
                                       "output")
        net = target.args[0] if isinstance(target.args, tuple) else None
        time_leaf = getattr(net, "time", None)
        if time_leaf is not None and str(time_leaf.dtype) != "torch.int32":
            findings.append(Finding(
                rule=self.name, target=target.name, severity="error",
                message=f"net.time is {time_leaf.dtype}, contract is int32 "
                        "(the reference's int-ms invariant)"))
        for site, n in sorted(float64_sites(target.recorder,
                                            allow).items()):
            findings.append(Finding(
                rule=self.name, target=target.name, severity="error",
                message=f"{n} float64 op output(s) at {site} — a 64-bit "
                        "float inside the chunk (allowlist key: "
                        f'"{site}::float64")'))
        n64 = sum("int64" in op.dtypes for op in target.recorder.ops)
        findings.append(Finding(
            rule=self.name, target=target.name, severity="info",
            metric="int64_ops", value=n64,
            message=f"{n64} ops with an int64 output (hash emulation, "
                    "indices)"))
        if not [f for f in findings if f.severity != "info"]:
            findings.append(Finding(
                rule=self.name, target=target.name, severity="info",
                message="carry is 32-bit-or-narrower, net.time is int32, "
                        "no float64 outside the allowlist"))
        return findings
