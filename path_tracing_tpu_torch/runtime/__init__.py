"""Runtime utilities of the front-ends: the live HTTP view
(``live_http``) and fault handling for long renders (``resilience``)."""
