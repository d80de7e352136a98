"""Analysis tools: deterministic fault injection (``chaos``), the runtime
thread-ownership sanitizer (``sanitize``) and the run doctor's diagnosis
core (``doctor``). No torch import anywhere in this package."""
