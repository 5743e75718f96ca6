"""Launch and footprint checker of the port (twin of ``repro.analysis``):
the kernel contract registry (``contracts``), the recorder it reads a
call through (``trace_check``), the port's AST lint (``ast_rules``) and
their CLI (``check``)."""
