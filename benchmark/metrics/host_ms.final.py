"""Mean milliseconds a render spends in the host layers around the
renderer's render phase: the harness's span around `cli.main` less the
`GLOBAL_TIMER` "<Renderer>.render" seconds the render added."""
from readers import host_ms as read  # noqa: F401
