"""Shared aiohttp client-session management and capped body reads — a copy
of ``ai4e_tpu/utils/http.py``."""

from __future__ import annotations

import asyncio

import aiohttp


async def read_body_limited(request, limit: int) -> bytes | None:
    """Request body within ``limit`` bytes, else None (callers answer 413).
    0 = unlimited. Checks the declared length first, then reads the stream
    incrementally and stops as soon as the running total exceeds the cap, so
    a chunked body with no declared length never buffers more than
    limit + one chunk."""
    if not limit:
        return await request.read()
    if (request.content_length or 0) > limit:
        return None
    chunks: list[bytes] = []
    total = 0
    while True:
        chunk = await request.content.readany()
        if not chunk:
            return b"".join(chunks)
        total += len(chunk)
        if total > limit:
            return None
        chunks.append(chunk)


class SessionHolder:
    """Lazily-created, recreate-if-closed ClientSession with a creation guard
    so concurrent first calls can't leak an extra session."""

    def __init__(self, timeout: float | None = None,
                 limit: int | None = None,
                 headers: dict[str, str] | None = None):
        """``limit``: max concurrent connections of the lazily-created
        session (0 = unbounded; None keeps aiohttp's default of 100);
        ``headers``: default headers sent on every request."""
        self._session: aiohttp.ClientSession | None = None
        self._timeout = timeout
        self._limit = limit
        self._headers = headers
        self._create_lock: asyncio.Lock | None = None

    async def get(self) -> aiohttp.ClientSession:
        if self._session is not None and not self._session.closed:
            return self._session
        if self._create_lock is None:
            self._create_lock = asyncio.Lock()
        async with self._create_lock:
            if self._session is None or self._session.closed:
                kw = {}
                if self._timeout is not None:
                    kw["timeout"] = aiohttp.ClientTimeout(total=self._timeout)
                if self._limit is not None:
                    kw["connector"] = aiohttp.TCPConnector(limit=self._limit)
                if self._headers:
                    kw["headers"] = dict(self._headers)
                self._session = aiohttp.ClientSession(**kw)
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
