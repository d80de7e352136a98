"""Analysis tools: deterministic fault injection (``chaos``), the runtime
thread-ownership sanitizer (``sanitize``), the run doctor (``doctor``),
the roofline and lineage readers, and the control-plane checkers
(``mrcheck``, ``mrmodel``). No torch import anywhere in this package."""
