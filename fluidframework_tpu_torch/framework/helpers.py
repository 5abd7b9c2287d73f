"""Framework helper packages — the small reference packages in one module.

Reference packages reproduced here (SURVEY.md §2.4 last row):
- ``request-handler``: composable URL-path request routing into a container
  (``buildRuntimeRequestHandler``).
- ``oldest-client-observer``: "am I the oldest connected client" signal for
  leader-style UI work (quorum join order, same order the summarizer
  election uses).
- ``view-adapters`` / ``view-interfaces``: adapt a DDS to a view — an
  observable snapshot that re-renders on every op.
- ``web-code-loader``: resolve the quorum's "code" proposal to a runnable
  container schema/factory from a registry.
- ``location-redirection-utils``: follow document relocations at resolve
  time.

A copy of ``fluidframework_tpu/framework/helpers.py``
with the port's imports; host-only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from fluidframework_tpu_torch.runtime.container import ContainerRuntime

# ---------------------------------------------------------------------------
# request-handler

RequestHandler = Callable[[List[str], ContainerRuntime], Optional[Any]]


def build_runtime_request_handler(*handlers: RequestHandler):
    """Compose handlers: first non-None response wins; 404 otherwise
    (reference request-handler/src/requestHandlers.ts)."""

    def handle(url: str, runtime: ContainerRuntime):
        parts = [p for p in url.split("/") if p]
        for h in handlers:
            res = h(parts, runtime)
            if res is not None:
                return res
        raise KeyError(f"no handler for {url!r}")

    return handle


def channel_request_handler(parts: List[str], runtime: ContainerRuntime):
    """Default route: /<channelId> resolves the channel object."""
    if len(parts) == 1 and parts[0] in runtime.channels:
        return runtime.channels[parts[0]]
    return None


# ---------------------------------------------------------------------------
# oldest-client-observer


class OldestClientObserver:
    """Reference oldest-client-observer: emits becameOldest/lostOldest as
    the quorum changes; ordering is join sequence (slots recycle)."""

    def __init__(self, runtime: ContainerRuntime):
        self._runtime = runtime
        self._was_oldest = self.is_oldest
        self._listeners: List[Callable[[bool], None]] = []

        def on_op(_msg):
            now = self.is_oldest
            if now != self._was_oldest:
                self._was_oldest = now
                for fn in list(self._listeners):
                    fn(now)

        self.detach = runtime.add_op_listener(on_op)

    @property
    def is_oldest(self) -> bool:
        members = self._runtime.quorum_members
        if self._runtime.client_id not in members:
            return False
        oldest = min(
            members.items(),
            key=lambda kv: (kv[1].get("join_seq", 0), kv[0]),
        )[0]
        return oldest == self._runtime.client_id

    def on_change(self, fn: Callable[[bool], None]) -> None:
        self._listeners.append(fn)


# ---------------------------------------------------------------------------
# view-adapters / view-interfaces


class ViewAdapter:
    """Adapt a DDS to a view: ``snapshot_fn(dds) -> view model``, re-derived
    after every applied op; subscribers get the fresh model (the
    reference's view-adapters bridge DDS events to rendering frameworks)."""

    def __init__(self, runtime: ContainerRuntime, channel_id: str,
                 snapshot_fn: Callable[[Any], Any]):
        self._runtime = runtime
        self._channel_id = channel_id
        self._snapshot_fn = snapshot_fn
        self._subs: List[Callable[[Any], None]] = []

        def on_op(msg):
            # Only ops addressed to the adapted channel change its view.
            if not self._subs:
                return
            contents = msg.contents if isinstance(msg.contents, dict) else {}
            if contents.get("address") != self._channel_id:
                return
            view = self.render()
            for fn in list(self._subs):
                fn(view)

        # Detachable: discarded adapters must not keep re-rendering forever.
        self.detach = runtime.add_op_listener(on_op)

    def render(self) -> Any:
        return self._snapshot_fn(self._runtime.channels[self._channel_id])

    def subscribe(self, fn: Callable[[Any], None]) -> None:
        self._subs.append(fn)
        fn(self.render())


# ---------------------------------------------------------------------------
# web-code-loader


class WebCodeLoader:
    """Reference web-code-loader: maps the quorum-approved "code" proposal
    value (a package descriptor) to a loadable container factory. The
    'code' key is the reference's canonical quorum proposal (C.3)."""

    CODE_KEY = "code"

    def __init__(self) -> None:
        self._registry: Dict[str, Any] = {}

    def register(self, package: str, factory: Any) -> None:
        self._registry[package] = factory

    def resolve(self, runtime: ContainerRuntime) -> Any:
        """The factory for the container's approved code proposal."""
        package = runtime.approved_proposals.get(self.CODE_KEY)
        if package is None:
            raise KeyError("container has no approved code proposal")
        if package not in self._registry:
            raise KeyError(f"code package {package!r} not registered")
        return self._registry[package]

    def propose_code(self, runtime: ContainerRuntime, package: str) -> None:
        runtime.propose(self.CODE_KEY, package)


# ---------------------------------------------------------------------------
# location-redirection-utils


class LocationRedirectionResolver:
    """Wrap a url resolver with relocation handling: a resolve that lands
    on a redirect record retries against the new location (reference
    location-redirection-utils handles odsp site moves)."""

    def __init__(self, resolve_fn: Callable[[str], str],
                 max_hops: int = 4):
        self._resolve = resolve_fn
        self._redirects: Dict[str, str] = {}
        self._max_hops = max_hops

    def add_redirect(self, old_url: str, new_url: str) -> None:
        self._redirects[old_url] = new_url

    def resolve(self, url: str) -> str:
        hops = 0
        while url in self._redirects:
            url = self._redirects[url]
            hops += 1
            if hops > self._max_hops:
                raise RuntimeError("redirect loop")
        return self._resolve(url)
