"""MySQL 4.1 wire-protocol frontend speaking SphinxQL.

Behavioral model: the reference's MySQL-wire loop (netreceive_ql.cpp:585-881
LoopClientMySQL: handshake, packet framing, OK/ERR/result-set encoding).
Implements protocol v10 handshake, COM_QUERY/COM_PING/COM_INIT_DB/COM_QUIT;
auth accepts any credentials (like the reference's default).

TLS: the handshake advertises CLIENT_SSL when a server context is
configured; a client SSLRequest (login packet with the SSL cap bit and no
credentials) upgrades the stream in place and the client re-sends its
login over TLS (netreceive_ql.cpp:848-852, searchdssl.cpp:524
MakeSecureLayer).

Compression: CLIENT_COMPRESS is always advertised; when the client's
login carries the bit, the compressed framing layer activates right
AFTER the auth OK is flushed (netreceive_ql.cpp:870-874) — every later
packet in both directions rides 7-byte compressed frames (3B payload
len, 1B compressed seq, 3B uncompressed len; 0 = stored raw; payloads
under 50 bytes stay raw — compressed_mysql.cpp:20,94).

Any MySQL client (mysql CLI, PyMySQL, connectors) can talk to this port.

The port's copy of ``manticoresearch_tpu/server/mysql.py``. Each
connection's ``Session`` runs on its catalog's device (the card for a
``Catalog(device="cuda")``). TLS imports ``cryptography`` only when a
listener asks for TLS without a certificate.
"""
from __future__ import annotations

import asyncio
import struct
import zlib

from ..exec.session import Catalog, QLResult, Session

CLIENT_PROTOCOL_41 = 0x0200
CLIENT_CONNECT_WITH_DB = 0x0008
CLIENT_COMPRESS = 0x0020
CLIENT_SSL = 0x0800
CLIENT_MULTI_RESULTS = 0x20000
CLIENT_PLUGIN_AUTH = 0x80000
SERVER_MORE_RESULTS_EXISTS = 0x0008

MIN_COMPRESS_LENGTH = 50   # compressed_mysql.cpp:20

COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E

SERVER_VERSION = b"5.5.21-manticoresearch-tpu"


def _lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 2**16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 2**24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def _lenenc_str(s: bytes) -> bytes:
    return _lenenc_int(len(s)) + s


class _TlsStream:
    """Server-side TLS over an existing asyncio stream pair via MemoryBIO
    (the KeepWorking read/write pump of SecureSocket_c, searchdssl.cpp:382).
    Unlike StreamWriter.start_tls, bytes the client pipelined behind its
    SSLRequest (the ClientHello often shares a TCP segment) stay readable:
    they sit in the StreamReader and feed the handshake naturally."""

    def __init__(self, reader, writer, ssl_ctx):
        import ssl as _ssl
        self.reader = reader
        self.writer = writer
        self._in = _ssl.MemoryBIO()
        self._out = _ssl.MemoryBIO()
        self._obj = ssl_ctx.wrap_bio(self._in, self._out, server_side=True)

    def _flush_out(self) -> None:
        d = self._out.read()
        if d:
            self.writer.write(d)

    async def handshake(self) -> None:
        import ssl as _ssl
        while True:
            try:
                self._obj.do_handshake()
                break
            except _ssl.SSLWantReadError:
                self._flush_out()
                await self.writer.drain()
                data = await self.reader.read(65536)
                if not data:
                    raise ConnectionError("eof during TLS handshake")
                self._in.write(data)
        self._flush_out()
        await self.writer.drain()

    async def readexactly(self, n: int) -> bytes:
        import ssl as _ssl
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._obj.read(n - len(buf))
            except _ssl.SSLWantReadError:
                data = await self.reader.read(65536)
                if not data:
                    raise asyncio.IncompleteReadError(buf, n)
                self._in.write(data)
                continue
            if not chunk:
                raise asyncio.IncompleteReadError(buf, n)
            buf += chunk
        return buf

    def write(self, data: bytes) -> None:
        self._obj.write(data)
        self._flush_out()

    async def drain(self) -> None:
        await self.writer.drain()


class _Conn:
    def __init__(self, reader, writer, session: Session, ssl_ctx=None):
        self.reader = reader
        self.writer = writer
        self.session = session
        self.seq = 0
        self.ssl_ctx = ssl_ctx
        self.is_ssl = False
        # compressed-layer state (MysqlCompressedSocket_c analog)
        self.compressed = False
        self._cseq = 0            # compressed-frame sequence counter
        self._cin = b""           # decompressed-but-unparsed inner bytes
        self._cout: list[bytes] = []   # inner packets pending one frame

    async def _readexactly(self, n: int) -> bytes:
        if self.is_ssl:
            return await self.tls.readexactly(n)
        return await self.reader.readexactly(n)

    def _write(self, data: bytes) -> None:
        if self.is_ssl:
            self.tls.write(data)
        else:
            self.writer.write(data)

    async def _read_frame_bytes(self, n: int) -> bytes | None:
        """n inner-protocol bytes through the compressed layer
        (ReadFromBackend, compressed_mysql.cpp:129)."""
        while len(self._cin) < n:
            try:
                head = await self._readexactly(7)
            except (asyncio.IncompleteReadError, ConnectionError):
                return None
            clen = head[0] | (head[1] << 8) | (head[2] << 16)
            self._cseq = head[3]
            ulen = head[4] | (head[5] << 8) | (head[6] << 16)
            try:
                body = await self._readexactly(clen)
            except (asyncio.IncompleteReadError, ConnectionError):
                return None
            self._cin += zlib.decompress(body) if ulen else body
        out, self._cin = self._cin[:n], self._cin[n:]
        return out

    async def read_packet(self) -> bytes | None:
        if self.compressed:
            head = await self._read_frame_bytes(4)
            if head is None:
                return None
            length = head[0] | (head[1] << 8) | (head[2] << 16)
            self.seq = head[3]
            return await self._read_frame_bytes(length)
        try:
            head = await self._readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        length = head[0] | (head[1] << 8) | (head[2] << 16)
        self.seq = head[3]
        try:
            return await self._readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None

    def send_packet(self, payload: bytes) -> None:
        self.seq = (self.seq + 1) % 256
        head = struct.pack("<I", len(payload))[:3] + bytes([self.seq])
        if self.compressed:
            self._cout.append(head + payload)
        else:
            self._write(head + payload)

    async def drain(self) -> None:
        """Flush pending inner packets as ONE compressed frame per batch
        (SendBuffer coalesces a whole response, compressed_mysql.cpp:117)."""
        if self.compressed and self._cout:
            blob = b"".join(self._cout)
            self._cout = []
            self._cseq = (self._cseq + 1) % 256
            if len(blob) < MIN_COMPRESS_LENGTH:
                head = (struct.pack("<I", len(blob))[:3]
                        + bytes([self._cseq]) + b"\x00\x00\x00")
                self._write(head + blob)
            else:
                comp = zlib.compress(blob)
                head = (struct.pack("<I", len(comp))[:3]
                        + bytes([self._cseq])
                        + struct.pack("<I", len(blob))[:3])
                self._write(head + comp)
        await self.writer.drain()

    # ---- packet builders ----
    def send_handshake(self) -> None:
        salt = b"12345678" + b"123456789012"
        caps = (CLIENT_PROTOCOL_41 | CLIENT_CONNECT_WITH_DB
                | CLIENT_COMPRESS)
        if self.ssl_ctx is not None:
            # advertise SSL only with valid keys (netreceive_ql.cpp:550)
            caps |= CLIENT_SSL
        payload = (
            b"\x0a" + SERVER_VERSION + b"\x00"
            + struct.pack("<I", 1)                      # thread id
            + salt[:8] + b"\x00"
            + struct.pack("<H", caps)
            + b"\x21"                                    # charset utf8
            + struct.pack("<H", 2)                       # status
            + struct.pack("<H", 0)                       # caps hi
            + bytes([len(salt) + 1])
            + b"\x00" * 10
            + salt[8:] + b"\x00"
        )
        self.seq = 255  # handshake is seq 0
        self.send_packet(payload)

    def send_ok(self, affected: int = 0, warning: str | None = None,
                more: bool = False) -> None:
        warnings = 1 if warning else 0
        status = 2 | (SERVER_MORE_RESULTS_EXISTS if more else 0)
        payload = (b"\x00" + _lenenc_int(affected) + _lenenc_int(0)
                   + struct.pack("<H", status) + struct.pack("<H", warnings))
        self.send_packet(payload)

    def send_err(self, msg: str, code: int = 1064) -> None:
        payload = (b"\xff" + struct.pack("<H", code) + b"#" + b"42000"
                   + msg.encode("utf-8"))
        self.send_packet(payload)

    def send_eof(self, more: bool = False) -> None:
        status = 2 | (SERVER_MORE_RESULTS_EXISTS if more else 0)
        self.send_packet(b"\xfe" + struct.pack("<H", 0)
                         + struct.pack("<H", status))

    def send_resultset(self, r: QLResult, more: bool = False) -> None:
        self.send_packet(_lenenc_int(len(r.columns)))
        for col in r.columns:
            name = col.encode("utf-8")
            payload = (
                _lenenc_str(b"def") + _lenenc_str(b"") + _lenenc_str(b"")
                + _lenenc_str(b"") + _lenenc_str(name) + _lenenc_str(name)
                + b"\x0c" + struct.pack("<H", 0x21)
                + struct.pack("<I", 255) + bytes([0xFD])
                + struct.pack("<H", 0) + b"\x00" + b"\x00\x00"
            )
            self.send_packet(payload)
        self.send_eof()
        for row in r.rows:
            out = b""
            for v in row:
                if v is None:
                    out += b"\xfb"
                else:
                    if isinstance(v, float) and v.is_integer():
                        s = repr(v)
                    elif isinstance(v, list):
                        # MVA column: bare comma-joined values
                        # (SendMysqlRow MVA render, searchd.cpp)
                        s = ",".join(str(x) for x in v)
                    else:
                        s = str(v)
                    out += _lenenc_str(s.encode("utf-8"))
            self.send_packet(out)
        self.send_eof(more)

    # ---- main loop ----
    async def run(self) -> None:
        self.send_handshake()
        await self.writer.drain()
        auth = await self.read_packet()
        if auth is None:
            return
        caps = struct.unpack("<I", auth[:4])[0] if len(auth) >= 4 else 0
        if (caps & CLIENT_SSL) and self.ssl_ctx is not None \
                and not self.is_ssl:
            # SSLRequest: upgrade in place, then the next packet is the
            # real login over TLS (netreceive_ql.cpp:848-852)
            self.tls = _TlsStream(self.reader, self.writer, self.ssl_ctx)
            import ssl as _ssl
            try:
                await self.tls.handshake()
            except (ConnectionError, OSError, _ssl.SSLError,
                    asyncio.IncompleteReadError):
                return
            self.is_ssl = True
            auth = await self.read_packet()
            if auth is None:
                return
            caps = struct.unpack("<I", auth[:4])[0] if len(auth) >= 4 else 0
        self.send_ok()
        await self.writer.drain()
        if caps & CLIENT_COMPRESS:
            # compression starts AFTER the auth OK is flushed
            # (netreceive_ql.cpp:870-874 MakeMysqlCompressedLayer)
            self.compressed = True
        while True:
            pkt = await self.read_packet()
            if pkt is None or not pkt:
                break
            cmd = pkt[0]
            if cmd == COM_QUIT:
                break
            if cmd in (COM_PING, COM_INIT_DB):
                self.send_ok()
            elif cmd == COM_FIELD_LIST:
                self.send_eof()
            elif cmd == COM_QUERY:
                sql = pkt[1:].decode("utf-8", "replace")
                results = self.session.execute(sql)
                for i, r in enumerate(results):
                    more = i + 1 < len(results)
                    if r.error:
                        self.send_err(r.error)
                        break  # error terminates a multi-result sequence
                    elif r.columns:
                        self.send_resultset(r, more=more)
                    else:
                        self.send_ok(r.affected, r.warning, more=more)
            else:
                self.send_err(f"unsupported command {cmd:#x}", 1047)
            await self.drain()


def make_server_ssl_context(cert_path: str | None = None,
                            key_path: str | None = None):
    """TLS context for the listeners (SetupSslCtx, searchdssl.cpp:152).
    With no cert configured, generates an in-memory self-signed pair (the
    reference refuses SSL without keys; we mint ephemeral ones so `ssl=on`
    works out of the box on dev boxes)."""
    import ssl as _ssl
    ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
    if cert_path and key_path:
        ctx.load_cert_chain(cert_path, key_path)
        return ctx
    import datetime
    import tempfile

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "manticoresearch-tpu")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .sign(key, hashes.SHA256()))
    with tempfile.NamedTemporaryFile(suffix=".pem") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
        f.write(cert.public_bytes(serialization.Encoding.PEM))
        f.flush()
        ctx.load_cert_chain(f.name)
    return ctx


class MysqlServer:
    def __init__(self, catalog: Catalog, host: str = "127.0.0.1",
                 port: int = 9306, ssl_cert: str | None = None,
                 ssl_key: str | None = None, ssl: bool = False):
        self.catalog = catalog
        self.host = host
        self.port = port
        self.ssl_ctx = None
        if ssl or (ssl_cert and ssl_key):
            self.ssl_ctx = make_server_ssl_context(ssl_cert, ssl_key)
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        host = f"{peer[0]}:{peer[1]}" if peer else "local"
        conn = _Conn(reader, writer, Session(self.catalog, proto="mysql",
                                             host=host),
                     ssl_ctx=self.ssl_ctx)
        try:
            await conn.run()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            conn.session.close()
            try:
                writer.close()
            except RuntimeError:
                pass  # event loop already gone at teardown


def run_mysql_server(catalog: Catalog, host="127.0.0.1", port=9306):
    asyncio.run(MysqlServer(catalog, host, port).serve_forever())
