"""The HTTP/1.1 layer both servers of the port share: the standard
library's asyncio streams (the machine with the card has no aiohttp),
keep-alive, ``Content-Length`` bodies, JSON answers.

A server lists its routes as ``(method, pattern, handler)``; a pattern
may hold path parameters (``/events/{event_id}.json``, or
``/plugins/{tail:.*}`` for the rest of the path), and the method ``*``
takes any method. A handler takes
a :class:`Request` and returns ``(status, payload)`` or ``(status,
payload, headers)``, or raises :class:`HttpError`. An unknown path
answers 404, a known path with another method 405, a handler that
raises anything else 500 with ``{"message": ...}``; the server keeps
serving.

A handler that answers something other than JSON returns a
:class:`RawBody` as its payload (``/metrics``: the Prometheus text
exposition). A server may pass a ``middleware`` (``obs/middleware``):
it runs around every dispatch, unknown paths and wrong methods
included, and sees the route's pattern as the handler label
(``__unmatched__`` when no route took the request).

A server may :meth:`~HttpServer.mount` another server's routes under a
prefix (the multi-tenant host mounts each tenant's query server under
``/t/{name}/``, where the reference uses aiohttp's ``add_subapp``). The
mounting server's own routes outrank a mount; a path they do not take
that starts with the prefix is matched against the mounted routes with
the prefix cut to ``/``. Only the mounting server's middleware runs
around it, so a request is observed once.

A listener may speak TLS: ``start`` (and :func:`serve_until_stopped`)
take an ``ssl.SSLContext`` (``utils/server_config.ServerConfig.
ssl_context``); a plain-HTTP request to it fails the handshake and gets
no answer. :meth:`Request.form` reads a form body as aiohttp's
``dict(await request.post())`` does (the webhooks' form connectors).
"""

from __future__ import annotations

import asyncio
import dataclasses
import email.parser
import email.policy
import functools
import http
import json
import logging
import re
import signal
import ssl
import threading
import urllib.parse
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("pio.torch.http")

#: largest request body accepted
MAX_BODY_BYTES = 16 << 20
#: how long a TLS connection's close waits for the peer's close_notify
#: (asyncio's default, 30 s, holds a stopping server on an idle client)
TLS_SHUTDOWN_TIMEOUT_S = 1.0


@dataclasses.dataclass
class Request:
    method: str
    path: str
    #: query parameters, the first value of each (aiohttp's
    #: ``request.query.get``)
    query: Dict[str, str]
    #: header names lower-cased
    headers: Dict[str, str]
    body: bytes
    params: Dict[str, str] = dataclasses.field(default_factory=dict)

    def json(self) -> Any:
        return json.loads(self.body)

    def form(self) -> Dict[str, str]:
        """The body's form fields as aiohttp's ``dict(await
        request.post())`` gives them: an ``x-www-form-urlencoded`` body
        percent-decoded in its charset (utf-8 unless named), blank values
        kept, the first value of a repeated key; a
        ``multipart/form-data`` body's text fields; no fields for another
        type (a missing or empty header is ``application/octet-stream``)
        or a method without a body."""
        if self.method not in _FORM_METHODS:
            return {}
        ctype, _, params = self.headers.get(
            "content-type", "application/octet-stream").partition(";")
        ctype = ctype.strip().lower()
        charset = "utf-8"
        for param in params.split(";"):
            name, _, value = param.strip().partition("=")
            if name.lower() == "charset" and value:
                charset = value.strip('"')
        out: Dict[str, str] = {}
        if ctype == "application/x-www-form-urlencoded":
            if self.body:
                for k, v in urllib.parse.parse_qsl(
                        self.body.rstrip().decode(charset),
                        keep_blank_values=True, encoding=charset):
                    out.setdefault(k, v)
        elif ctype == "multipart/form-data":
            msg = email.parser.BytesParser(
                policy=email.policy.HTTP).parsebytes(
                b"Content-Type: " + self.headers["content-type"].encode(
                    "latin-1") + b"\r\n\r\n" + self.body)
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name is None:
                    raise ValueError("Multipart field missing name.")
                if part.get_filename() is None:
                    data = part.get_payload(decode=True) or b""
                    out.setdefault(name, data.decode(
                        part.get_content_charset() or "utf-8"))
        return out


@dataclasses.dataclass
class RawBody:
    """A payload sent as these bytes under this ``Content-Type``, not as
    JSON."""

    data: bytes
    content_type: str


#: the methods whose form body ``Request.form`` reads (aiohttp's
#: ``POST_METHODS``)
_FORM_METHODS = frozenset({"PATCH", "POST", "PUT", "TRACE", "DELETE"})

#: the handler label of a request no route took (the reference's)
UNMATCHED = "__unmatched__"


class HttpError(Exception):
    """Raised by a handler to answer ``status`` with ``payload``."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.payload = {"message": message}


class _BadRequest(Exception):
    pass


Handler = Callable[[Request], Awaitable[tuple]]
#: ``middleware(request, handler_label, call)``: ``call()`` dispatches
#: and returns ``(status, payload, headers)``; so does the middleware
Middleware = Callable[[Request, str, Callable[[], Awaitable[tuple]]],
                      Awaitable[tuple]]


def _compile(pattern: str) -> "re.Pattern":
    """``{name}`` matches one path segment, ``{name:regex}`` the regex
    (``{tail:.*}``: the rest of the path)."""
    out, pos = "", 0
    for m in re.finditer(r"\{(\w+)(?::([^}]+))?\}", pattern):
        out += (re.escape(pattern[pos:m.start()])
                + f"(?P<{m.group(1)}>{m.group(2) or '[^/]+?'})")
        pos = m.end()
    return re.compile("^" + out + re.escape(pattern[pos:]) + "$")


class HttpServer:
    """Routes and the connection loop. ``start`` binds on the running
    event loop and returns the port (``port=0`` picks a free one)."""

    def __init__(self, routes: List[Tuple[str, str, Handler]],
                 middleware: Optional[Middleware] = None):
        self._routes = [(method, pattern, _compile(pattern), handler)
                        for method, pattern, handler in routes]
        self._middleware = middleware
        #: prefix ("/t/alpha/") -> the server whose routes it mounts
        self._mounts: Dict[str, "HttpServer"] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        #: open connections -> whether a request is being handled on it
        self._conns: Dict[asyncio.StreamWriter, bool] = {}
        self._closing = False

    async def start(self, host: str, port: int,
                    ssl_context: Optional[ssl.SSLContext] = None) -> int:
        """Bind; with ``ssl_context`` every connection speaks TLS."""
        tls = {} if ssl_context is None else {
            "ssl": ssl_context,
            "ssl_shutdown_timeout": TLS_SHUTDOWN_TIMEOUT_S}
        self._server = await asyncio.start_server(
            self._handle_conn, host, port, **tls)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        """Stop accepting; idle keep-alive connections are closed, busy
        ones after their answer."""
        if self._server is None:
            return
        self._closing = True
        self._server.close()
        for writer, busy in list(self._conns.items()):
            if not busy:
                # nothing is in flight on an idle connection: drop it
                # without waiting on the peer's TLS close
                writer.transport.abort()
        await self._server.wait_closed()

    def mount(self, prefix: str, server: "HttpServer") -> None:
        """Serve ``server``'s routes under ``prefix`` (its handlers see
        the whole path; their pattern, under the prefix, is the handler
        label). The mounted server's middleware does not run."""
        self._mounts["/" + prefix.strip("/") + "/"] = server

    def _match(self, path: str, method: str, allowed: list):
        """The first route taking ``path`` and ``method``:
        ``(pattern, handler, params)``, or None; the methods of routes
        that take the path only are appended to ``allowed``."""
        for r_method, pattern, regex, handler in self._routes:
            m = regex.match(path)
            if m is None:
                continue
            if r_method not in ("*", method):
                allowed.append(r_method)
                continue
            return pattern, handler, m.groupdict()
        return None

    async def dispatch(self, req: Request
                       ) -> Tuple[int, Any, Dict[str, str]]:
        allowed: list = []
        found = self._match(req.path, req.method, allowed)
        if found is None:
            for prefix, sub in self._mounts.items():
                if req.path.startswith(prefix):
                    found = sub._match(req.path[len(prefix) - 1:],
                                       req.method, allowed)
                    if found is not None:
                        found = (prefix[:-1] + found[0],) + found[1:]
                    break
        if found is not None:
            pattern, handler, req.params = found
            return await self._run(req, pattern,
                                   functools.partial(_call, handler, req))
        if allowed:
            out = (405, {"message": f"{req.path} takes "
                                    f"{'/'.join(allowed)}"}, {})
        else:
            out = (404, {"message": f"no route {req.path}"}, {})

        async def answer():
            return out
        return await self._run(req, UNMATCHED, answer)

    async def _run(self, req: Request, label: str, call):
        if self._middleware is None:
            return await call()
        return await self._middleware(req, label, call)

    async def _read_request(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter
                            ) -> Optional[Tuple[Request, str]]:
        line = await reader.readline()
        if not line:
            return None
        self._conns[writer] = True
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            raise _BadRequest("malformed request line") from None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        path, _, qs = target.partition("?")
        query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(qs, keep_blank_values=True):
            query.setdefault(k, v)
        req = Request(method=method.upper(), path=urllib.parse.unquote(path),
                      query=query, headers=headers, body=b"")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            req.body = None        # answered 411 by the caller
            return req, version
        try:
            n = int(headers.get("content-length") or 0)
        except ValueError:
            raise _BadRequest("bad Content-Length") from None
        if n < 0 or n > MAX_BODY_BYTES:
            raise _BadRequest(f"body of {n} bytes refused")
        req.body = await reader.readexactly(n) if n else b""
        return req, version

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns[writer] = False
        try:
            while True:
                try:
                    got = await self._read_request(reader, writer)
                except _BadRequest as e:
                    await _respond(writer, 400, {"message": str(e)}, {},
                                   keep_alive=False)
                    return
                if got is None:
                    return
                req, version = got
                keep_alive = (version == "HTTP/1.1" and req.headers.get(
                    "connection", "").lower() != "close")
                if req.body is None:
                    status, payload, headers = 411, {
                        "message": "chunked bodies are not accepted; send "
                                   "Content-Length"}, {}
                    keep_alive = False
                else:
                    status, payload, headers = await self.dispatch(req)
                await _respond(writer, status, payload, headers,
                               keep_alive and not self._closing)
                if not keep_alive or self._closing:
                    return
                self._conns[writer] = False
        except (OSError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError):
            # a peer that vanished, a line past the stream's limit or a
            # broken or timed-out TLS stream (OSError covers
            # ConnectionError, ssl.SSLError and TimeoutError): drop the
            # connection
            pass
        finally:
            self._conns.pop(writer, None)
            writer.close()


async def _call(handler: Handler, req: Request
                ) -> Tuple[int, Any, Dict[str, str]]:
    try:
        out = await handler(req)
    except HttpError as e:
        return e.status, e.payload, {}
    except Exception as e:      # the server must keep serving
        logger.exception("handler failed")
        return 500, {"message": repr(e)}, {}
    return out if len(out) == 3 else (out[0], out[1], {})


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Error"


async def _respond(writer: asyncio.StreamWriter, status: int, payload: Any,
                   headers: Dict[str, str], keep_alive: bool) -> None:
    if isinstance(payload, RawBody):
        data, ctype = payload.data, payload.content_type
    else:
        data = json.dumps(payload).encode()
        ctype = "application/json; charset=utf-8"
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    head = (f"HTTP/1.1 {status} {_reason(status)}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(data)}\r\n{extra}"
            f"Connection: {'keep-alive' if keep_alive else 'close'}"
            "\r\n\r\n")
    writer.write(head.encode("latin-1") + data)
    await writer.drain()


def serve_until_stopped(server, host: str, port: int,
                        on_ready: Optional[Callable[[int], None]] = None,
                        ssl_context: Optional[ssl.SSLContext] = None
                        ) -> None:
    """Run ``server`` (``start(host, port)``, ``close()`` and a
    ``stopped`` asyncio.Event) on a new event loop until ``stopped`` is
    set or the process gets SIGINT or SIGTERM (handled when called on
    the main thread); then ``close()`` runs, so a server's shutdown work
    (the event server's buffer drain) is done. ``on_ready(port)`` runs
    once the socket is bound. With ``ssl_context`` the server listens
    over TLS (its ``start`` takes ``ssl_context=``)."""
    async def _main():
        if threading.current_thread() is threading.main_thread():
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, server.stopped.set)
        if ssl_context is None:
            bound = await server.start(host, port)
        else:
            bound = await server.start(host, port, ssl_context=ssl_context)
        if on_ready is not None:
            on_ready(bound)
        try:
            await server.stopped.wait()
        finally:
            await server.close()

    asyncio.run(_main())
