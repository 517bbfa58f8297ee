"""S3 filesystem for the data layer's filesystem seam (counterpart of
``ray_tpu/data/s3_filesystem.py``, the same code).

Reference capability: the reference's datasources read/write
``s3://bucket/key`` through pyarrow's S3 filesystem. This build has no
boto/pyarrow-s3; here is a dependency-free implementation over the S3
REST API (stdlib urllib + hmac): AWS Signature V4 signing when
credentials are present, anonymous requests otherwise — so it works
against real S3, MinIO, or the in-repo mock used by tests
(reference test pattern: ``python/ray/data/tests/mock_s3_server.py``).

Activate with::

    from ray_tpu_torch.data.s3_filesystem import S3FileSystem, enable_s3
    enable_s3()                                  # s3:// via env creds
    enable_s3(endpoint_url="http://127.0.0.1:9000")   # MinIO/mock

Paths inside the seam are ``bucket/key...`` (scheme already stripped by
``resolve_filesystem``).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import IO, List, Optional, Tuple
from xml.etree import ElementTree

from ray_tpu_torch.data.filesystem import FileSystem, register_filesystem


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3FileSystem(FileSystem):
    scheme = "s3"

    def __init__(self, endpoint_url: Optional[str] = None,
                 region: str = "us-east-1",
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        self.endpoint = (endpoint_url
                         or f"https://s3.{region}.amazonaws.com").rstrip("/")
        self.region = region
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY")

    # -- request plumbing -------------------------------------------------
    def _sign(self, method: str, path: str, query: str,
              payload: bytes) -> dict:
        """AWS SigV4 headers (anonymous when no credentials)."""
        host = urllib.parse.urlparse(self.endpoint).netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = _sha256(payload)
        headers = {"host": host, "x-amz-date": amz_date,
                   "x-amz-content-sha256": payload_hash}
        if not (self.access_key and self.secret_key):
            headers.pop("x-amz-content-sha256")
            return headers
        signed = ";".join(sorted(headers))
        canonical = "\n".join([
            method, urllib.parse.quote(path), query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             _sha256(canonical.encode())])
        key = _hmac(_hmac(_hmac(_hmac(
            ("AWS4" + self.secret_key).encode(), datestamp),
            self.region), "s3"), "aws4_request")
        signature = hmac.new(key, to_sign.encode(),
                             hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}")
        return headers

    def _request(self, method: str, path: str, query: str = "",
                 payload: bytes = b"") -> Tuple[int, bytes]:
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + query
        req = urllib.request.Request(
            url, data=payload if method in ("PUT", "POST") else None,
            method=method,
            headers=self._sign(method, path, query, payload))
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        bucket, _, key = path.partition("/")
        return bucket, key

    # -- FileSystem protocol ----------------------------------------------
    def open_input(self, path: str) -> IO[bytes]:
        bucket, key = self._split(path)
        status, body = self._request("GET", f"/{bucket}/{key}")
        if status == 404:
            raise FileNotFoundError(f"s3://{path}")
        if status != 200:
            raise IOError(f"s3 GET {path}: HTTP {status}: {body[:200]!r}")
        return io.BytesIO(body)

    def open_output(self, path: str) -> IO[bytes]:
        fs = self

        class _Writer(io.BytesIO):
            _aborted = False

            def __exit__(self, exc_type, exc, tb):
                # an exception inside the `with` block must NOT upload
                # the partial buffer (a truncated object would corrupt
                # the dataset) nor mask the original error
                if exc_type is not None:
                    self._aborted = True
                return super().__exit__(exc_type, exc, tb)

            def close(self) -> None:
                if self.closed:
                    return
                aborted = self._aborted
                data = self.getvalue()
                super().close()
                if aborted:
                    return
                bucket, key = fs._split(path)
                status, body = fs._request("PUT", f"/{bucket}/{key}",
                                           payload=data)
                if status not in (200, 201):
                    raise IOError(f"s3 PUT {path}: HTTP {status}: "
                                  f"{body[:200]!r}")

        return _Writer()

    def exists(self, path: str) -> bool:
        bucket, key = self._split(path)
        if not key:
            return True
        status, _ = self._request("HEAD", f"/{bucket}/{key}")
        if status == 200:
            return True
        return bool(self._list(bucket, key.rstrip("/") + "/",
                               max_keys=1)[0])

    def isdir(self, path: str) -> bool:
        bucket, key = self._split(path)
        if not key:
            return True
        status, _ = self._request("HEAD", f"/{bucket}/{key}")
        if status == 200 and not key.endswith("/"):
            return False
        return bool(self._list(bucket, key.rstrip("/") + "/",
                               max_keys=1)[0])

    def _list(self, bucket: str, prefix: str, delimiter: str = "",
              max_keys: int = 1000) -> Tuple[List[str], List[str]]:
        # canonical (SigV4) form: sorted pairs, %-encoding with the
        # AWS-unreserved charset — the same string is signed and sent
        params = {"list-type": "2", "prefix": prefix,
                  "max-keys": str(max_keys),
                  **({"delimiter": delimiter} if delimiter else {})}
        query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(str(v), safe='-_.~')}"
            for k, v in sorted(params.items()))
        status, body = self._request("GET", f"/{bucket}", query=query)
        if status != 200:
            raise IOError(f"s3 LIST {bucket}/{prefix}: HTTP {status}")
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        root = ElementTree.fromstring(body)
        keys = [el.findtext(f"{ns}Key") for el in root.iter(f"{ns}Contents")]
        prefixes = [el.findtext(f"{ns}Prefix")
                    for el in root.iter(f"{ns}CommonPrefixes")]
        return [k for k in keys if k], [p for p in prefixes if p]

    def listdir(self, path: str) -> List[str]:
        bucket, key = self._split(path)
        prefix = key.rstrip("/") + "/" if key else ""
        keys, prefixes = self._list(bucket, prefix, delimiter="/")
        out = [f"{bucket}/{k}" for k in keys if k != prefix]
        out += [f"{bucket}/{p.rstrip('/')}" for p in prefixes]
        return sorted(out)

    def glob(self, pattern: str) -> List[str]:
        import fnmatch

        bucket, key = self._split(pattern)
        prefix = key.split("*", 1)[0]
        keys, _ = self._list(bucket, prefix)
        return sorted(f"{bucket}/{k}" for k in keys
                      if fnmatch.fnmatch(k, key))

    def makedirs(self, path: str) -> None:
        pass   # S3 has no directories


def enable_s3(**kwargs) -> S3FileSystem:
    """Register s3:// with the data layer (register_filesystem seam)."""
    fs = S3FileSystem(**kwargs)
    register_filesystem("s3", fs)
    return fs


class GcsFileSystem(S3FileSystem):
    """Google Cloud Storage via its documented XML interoperability API
    (reference capability: gs:// datasources through pyarrow's GcsFileSystem).

    GCS's interop mode speaks the same XML protocol and SigV4 HMAC
    signing as S3 (https://cloud.google.com/storage/docs/interoperability),
    so this is the S3 implementation pointed at
    ``storage.googleapis.com`` with GCS HMAC credentials
    (``GS_ACCESS_KEY_ID``/``GS_SECRET_ACCESS_KEY``, falling back to the
    AWS names for mocks/MinIO-style endpoints). Anonymous requests work
    for public buckets and test servers."""

    scheme = "gs"

    def __init__(self, endpoint_url: Optional[str] = None,
                 region: str = "auto",
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None):
        super().__init__(
            endpoint_url=endpoint_url or "https://storage.googleapis.com",
            region=region,
            access_key=access_key or os.environ.get("GS_ACCESS_KEY_ID"),
            secret_key=secret_key or os.environ.get(
                "GS_SECRET_ACCESS_KEY"))


def enable_gs(**kwargs) -> GcsFileSystem:
    """Register gs:// (and gcs://) with the data layer."""
    fs = GcsFileSystem(**kwargs)
    register_filesystem("gs", fs)
    register_filesystem("gcs", fs)
    return fs
