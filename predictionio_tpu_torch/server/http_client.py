"""An HTTP/1.1 client on the standard library's asyncio streams, for the
router and the load test's fleet (the machine with the card has no
aiohttp, whose ``ClientSession`` the reference's router uses).

It keeps a pool of keep-alive connections per origin: ``server/http``
answers HTTP/1.1 with keep-alive, and a fresh connection per proxied
query would add a connect to every query and churn TIME_WAIT at
thousands of queries a second. Every request runs under a timeout that
covers the connect, the write and the whole answer; a connection whose
request timed out or failed is closed, never pooled. A request that
fails on a pooled connection before any byte of the answer arrived
(the peer closed it while it was idle) is sent once more on a fresh
connection.

Bodies are ``Content-Length`` framed both ways (``server/http`` answers
that way); a chunked answer is refused with :class:`HttpClientError`.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import urllib.parse
from typing import Any, Deque, Dict, Optional, Tuple

#: idle connections kept per origin
POOL_SIZE = 64
#: largest answer body read
MAX_BODY_BYTES = 64 << 20


class HttpClientError(Exception):
    """A malformed or truncated answer, or a connection the peer closed
    before answering."""


class _Unanswered(HttpClientError):
    """The peer closed the connection before any byte of the answer."""


@dataclasses.dataclass
class Response:
    status: int
    body: bytes
    #: header names lower-cased
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)

    def json(self) -> Any:
        return json.loads(self.body)


_Conn = Tuple[asyncio.StreamReader, asyncio.StreamWriter]


class HttpClient:
    """``await request(method, url, ...)`` -> :class:`Response`; raises
    ``asyncio.TimeoutError``, ``OSError`` or :class:`HttpClientError`.
    One client per event loop; :meth:`close` drops the pooled
    connections."""

    def __init__(self):
        self._idle: Dict[Tuple[str, int], Deque[_Conn]] = {}
        self._closed = False

    async def request(self, method: str, url: str, *,
                      body: bytes = b"",
                      params: Optional[Dict[str, str]] = None,
                      headers: Optional[Dict[str, str]] = None,
                      json_body: Any = None,
                      timeout: float = 30.0) -> Response:
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers = {"Content-Type": "application/json",
                       **(headers or {})}
        parts = urllib.parse.urlsplit(url)
        if parts.scheme != "http":
            raise HttpClientError(f"only http:// URLs are served: {url}")
        host, port = parts.hostname, parts.port or 80
        target = parts.path or "/"
        query = parts.query
        if params:
            extra = urllib.parse.urlencode(params)
            query = f"{query}&{extra}" if query else extra
        if query:
            target = f"{target}?{query}"
        head = [f"{method} {target} HTTP/1.1", f"Host: {host}:{port}",
                f"Content-Length: {len(body)}", "Connection: keep-alive"]
        head += [f"{k}: {v}" for k, v in (headers or {}).items()]
        payload = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body
        return await asyncio.wait_for(
            self._exchange((host, port), payload), timeout=timeout)

    async def _exchange(self, origin: Tuple[str, int],
                        payload: bytes) -> Response:
        conn, reused = self._checkout(origin)
        if conn is None:
            conn = await asyncio.open_connection(*origin)
        try:
            try:
                resp, keep = await self._roundtrip(conn, payload)
            except _Unanswered:
                if not reused:
                    raise
                # a pooled connection the peer closed while it was idle:
                # the request never reached a handler, send it once more
                _close(conn)
                conn = await asyncio.open_connection(*origin)
                resp, keep = await self._roundtrip(conn, payload)
        except BaseException:
            _close(conn)
            raise
        if keep and not self._closed:
            idle = self._idle.setdefault(origin, collections.deque())
            if len(idle) < POOL_SIZE:
                idle.append(conn)
                return resp
        _close(conn)
        return resp

    def _checkout(self, origin) -> Tuple[Optional[_Conn], bool]:
        idle = self._idle.get(origin)
        while idle:
            conn = idle.pop()
            if not conn[1].is_closing() and not conn[0].at_eof():
                return conn, True
            _close(conn)
        return None, False

    @staticmethod
    async def _roundtrip(conn: _Conn, payload: bytes
                         ) -> Tuple[Response, bool]:
        reader, writer = conn
        try:
            writer.write(payload)
            await writer.drain()
            line = await reader.readline()
        except ConnectionError as e:
            raise _Unanswered(f"connection lost before the answer: {e}"
                              ) from None
        if not line:
            raise _Unanswered("connection closed before the answer")
        try:
            version, status, _ = (line.decode("latin-1").rstrip("\r\n")
                                  + " ").split(" ", 2)
            status = int(status)
        except ValueError:
            raise HttpClientError(
                f"malformed status line {line[:80]!r}") from None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n"):
                break
            if not h:
                raise HttpClientError("connection closed in the headers")
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise HttpClientError("chunked answers are not read")
        length = headers.get("content-length")
        try:
            if length is not None:
                n = int(length)
                if not 0 <= n <= MAX_BODY_BYTES:
                    raise ValueError(n)
                data = await reader.readexactly(n) if n else b""
            else:
                # no length: the body runs to the end of the connection
                data = await reader.read(MAX_BODY_BYTES)
        except (ValueError, asyncio.IncompleteReadError) as e:
            raise HttpClientError(f"truncated answer: {e}") from None
        keep = (length is not None and version == "HTTP/1.1"
                and headers.get("connection", "").lower() != "close")
        return Response(status, data, headers), keep

    async def close(self) -> None:
        self._closed = True
        for idle in self._idle.values():
            while idle:
                _close(idle.pop())
        self._idle.clear()


def _close(conn: _Conn) -> None:
    try:
        conn[1].close()
    except Exception:       # noqa: BLE001 — closing a dead socket
        pass
