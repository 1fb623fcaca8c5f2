"""Dispatch audits of the port's entry points (reference: ``repro.analysis``).

The reference traces jaxprs; the port runs each entry point once on the
device it is given, under an op census (every aten op, host reads,
device-to-host copies, float64 results) and an exchange census (every
stacked-transport and model-axis exchange, in issue order), and holds
the counts to the same contracts (``auditor``).  ``python -m
repro_torch.analysis --audit`` runs the sweep.  The reference's AST
lint is not ported: it already reads ``src/repro_torch/``.
"""
from .auditor import (ExchangeCensus, OpCensus, audit_callable,
                      audit_engine, audit_overlap_sync, audit_reduce,
                      audit_serve_decode)
from .violations import AuditReport, CheckResult, Severity

__all__ = ["AuditReport", "CheckResult", "ExchangeCensus", "OpCensus",
           "Severity", "audit_callable", "audit_engine",
           "audit_overlap_sync", "audit_reduce", "audit_serve_decode"]
