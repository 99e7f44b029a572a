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
"""

from __future__ import annotations

import asyncio
import dataclasses
import http
import json
import logging
import re
import signal
import threading
import urllib.parse
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("pio.torch.http")

#: largest request body accepted
MAX_BODY_BYTES = 16 << 20


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


class HttpError(Exception):
    """Raised by a handler to answer ``status`` with ``payload``."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.payload = {"message": message}


class _BadRequest(Exception):
    pass


Handler = Callable[[Request], Awaitable[tuple]]


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

    def __init__(self, routes: List[Tuple[str, str, Handler]]):
        self._routes = [(method, _compile(pattern), handler)
                        for method, pattern, handler in routes]
        self._server: Optional[asyncio.AbstractServer] = None
        #: open connections -> whether a request is being handled on it
        self._conns: Dict[asyncio.StreamWriter, bool] = {}
        self._closing = False

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._handle_conn,
                                                  host, port)
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
                writer.close()
        await self._server.wait_closed()

    async def dispatch(self, req: Request
                       ) -> Tuple[int, Any, Dict[str, str]]:
        allowed = []
        for method, regex, handler in self._routes:
            m = regex.match(req.path)
            if m is None:
                continue
            if method not in ("*", req.method):
                allowed.append(method)
                continue
            req.params = m.groupdict()
            try:
                out = await handler(req)
            except HttpError as e:
                return e.status, e.payload, {}
            except Exception as e:      # the server must keep serving
                logger.exception("handler failed")
                return 500, {"message": repr(e)}, {}
            return out if len(out) == 3 else (out[0], out[1], {})
        if allowed:
            return 405, {"message": f"{req.path} takes "
                                    f"{'/'.join(allowed)}"}, {}
        return 404, {"message": f"no route {req.path}"}, {}

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
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError):
            # a peer that vanished, or a line past the stream's limit:
            # drop the connection
            pass
        finally:
            self._conns.pop(writer, None)
            writer.close()


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Error"


async def _respond(writer: asyncio.StreamWriter, status: int, payload: Any,
                   headers: Dict[str, str], keep_alive: bool) -> None:
    data = json.dumps(payload).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    head = (f"HTTP/1.1 {status} {_reason(status)}\r\n"
            "Content-Type: application/json; charset=utf-8\r\n"
            f"Content-Length: {len(data)}\r\n{extra}"
            f"Connection: {'keep-alive' if keep_alive else 'close'}"
            "\r\n\r\n")
    writer.write(head.encode("latin-1") + data)
    await writer.drain()


def serve_until_stopped(server, host: str, port: int,
                        on_ready: Optional[Callable[[int], None]] = None
                        ) -> None:
    """Run ``server`` (``start(host, port)``, ``close()`` and a
    ``stopped`` asyncio.Event) on a new event loop until ``stopped`` is
    set or the process gets SIGINT or SIGTERM (handled when called on
    the main thread); then ``close()`` runs, so a server's shutdown work
    (the event server's buffer drain) is done. ``on_ready(port)`` runs
    once the socket is bound."""
    async def _main():
        if threading.current_thread() is threading.main_thread():
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, server.stopped.set)
        bound = await server.start(host, port)
        if on_ready is not None:
            on_ready(bound)
        try:
            await server.stopped.wait()
        finally:
            await server.close()

    asyncio.run(_main())
