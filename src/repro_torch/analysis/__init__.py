"""dalek-lint for the port: AST static analysis of the repo's discipline,
with the JAX-specific rules retargeted to PyTorch.

Importing the package registers every rule module; ``python -m
repro_torch.analysis`` runs the CLI. Rules (see ``--list-rules``):

=======  =====================  ==============================================
DLK001   bare-compile           torch.compile/jit/CUDA graph outside counting_call
DLK002   host-sync              device->host sync inside an engine hot loop
DLK003   device-branch          python control flow on a tensor in a counted step
DLK004   step-kwargs            counting_call wiring that defeats the count
DLK005   untagged-energy        MonitorSession.sample with no region()/tags
DLK006   refcount-pairing       PagePool block acquired but not consumed/released
DLK007   unclosed-span          obs.Tracer span opened but never ended
DLK008   state-reset-pairing    slot released for reuse without adapter reset
DLK009   interproc-host-sync    device value synced inside a helper called from a hot loop
DLK010   dtype-drift            carry returned in a drifted dtype (new step signature)
DLK011   ownership-handoff      block/span handle passed to a non-consuming callee
DLK012   unguarded-shared-state field accessed both under self._lock and bare
=======  =====================  ==============================================

The JAX linter (``repro.analysis``) takes its taint from ``jax.jit`` and
``counting_jit``; this one takes it from ``counting_call`` and the
``make_*`` step factories, and knows torch's syncs (``.item()``,
``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``) and casts
(``.to(x.dtype)``, ``.type_as``). DLK005-DLK008, DLK011 and DLK012 do not
depend on the framework and give the JAX linter's findings on the same
source. The pragma syntax, ``# dalek: allow[<slug>] <why>``, is the same,
so one pragma serves both linters.

DLK009–DLK012 are interprocedural: they read function summaries off a
:class:`repro_torch.analysis.project.ProjectIndex` (``--project`` on the
CLI; single-file runs get a one-module index automatically).
"""
from repro_torch.analysis.core import (Finding, ModuleContext,  # noqa: F401
                                       Rule, all_rules, analyze_paths,
                                       analyze_source, check_module,
                                       rule_codes, select_rules)
from repro_torch.analysis.project import (FunctionSummary,  # noqa: F401
                                          ProjectIndex, analyze_project)
# importing the rule modules populates the registry
from repro_torch.analysis import (rules_dtype, rules_energy,  # noqa: F401
                                  rules_host, rules_interproc, rules_jit,
                                  rules_obs, rules_race, rules_refcount,
                                  rules_state)
from repro_torch.analysis.baseline import DEFAULT_BASELINE  # noqa: F401
