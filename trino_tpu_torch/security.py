"""Security: identities, authentication, and access control.

Counterpart of trino_tpu/security.py, copied (pure Python).  Reference
parity: spi/security/ (Identity, AccessDeniedException,
SystemAccessControl), security/AccessControlManager (chained checks),
server/security/PasswordAuthenticator + the file-based rule plugins
(plugin/trino-password-authenticators' password file, and the file-based
system access control's catalog/table rules).  The session checks a
statement's plan before any scan loads or any kernel launches.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Identity:
    """spi/security/Identity: the authenticated principal."""

    user: str
    groups: tuple = ()


class AccessDeniedError(PermissionError):
    """spi/security/AccessDeniedException."""


class AccessControl:
    """SystemAccessControl SPI subset: every method either returns or
    raises AccessDeniedError."""

    def check_can_execute_query(self, identity: Identity):
        pass

    def check_can_select(self, identity: Identity, catalog: str,
                         table: str, columns: Sequence[str]):
        pass

    def check_can_insert(self, identity: Identity, catalog: str, table: str):
        pass

    def check_can_delete(self, identity: Identity, catalog: str, table: str):
        pass

    def check_can_create_table(self, identity: Identity, catalog: str,
                               table: str):
        pass

    def check_can_drop_table(self, identity: Identity, catalog: str,
                             table: str):
        pass

    def check_can_set_session(self, identity: Identity, name: str):
        pass


class AllowAllAccessControl(AccessControl):
    pass


class FileBasedAccessControl(AccessControl):
    """Rule-list access control (the file-based SystemAccessControl):

    rules = {
      "catalogs": [{"user": glob, "catalog": glob,
                    "allow": "all"|"read-only"|"none"}, ...],
      "tables":   [{"user": glob, "catalog": glob, "table": glob,
                    "privileges": ["SELECT","INSERT","DELETE",
                                    "OWNERSHIP"]}, ...],
    }
    First matching rule wins; no catalog rule match denies the catalog,
    no table-rule section means tables inherit the catalog decision.
    """

    def __init__(self, rules: dict):
        self.catalog_rules: List[dict] = list(rules.get("catalogs", ()))
        self.table_rules: Optional[List[dict]] = (
            list(rules["tables"]) if "tables" in rules else None
        )

    def _catalog_access(self, identity: Identity, catalog: str) -> str:
        for r in self.catalog_rules:
            if not fnmatch.fnmatch(identity.user, r.get("user", "*")):
                continue
            if not fnmatch.fnmatch(catalog, r.get("catalog", "*")):
                continue
            return r.get("allow", "all")
        return "none"

    def _table_privileges(self, identity: Identity, catalog: str,
                          table: str) -> List[str]:
        if self.table_rules is None:
            access = self._catalog_access(identity, catalog)
            if access == "all":
                return ["SELECT", "INSERT", "DELETE", "OWNERSHIP"]
            if access == "read-only":
                return ["SELECT"]
            return []
        for r in self.table_rules:
            if not fnmatch.fnmatch(identity.user, r.get("user", "*")):
                continue
            if not fnmatch.fnmatch(catalog, r.get("catalog", "*")):
                continue
            if not fnmatch.fnmatch(table, r.get("table", "*")):
                continue
            return list(r.get("privileges", ()))
        return []

    def _require(self, identity, catalog, table, privilege):
        if self._catalog_access(identity, catalog) == "none":
            raise AccessDeniedError(
                f"Access Denied: Cannot access catalog {catalog}"
            )
        if privilege not in self._table_privileges(identity, catalog, table):
            raise AccessDeniedError(
                f"Access Denied: Cannot {privilege.lower()} from/into "
                f"table {catalog}.{table}"
            )

    def check_can_select(self, identity, catalog, table, columns):
        self._require(identity, catalog, table, "SELECT")

    def check_can_insert(self, identity, catalog, table):
        self._require(identity, catalog, table, "INSERT")

    def check_can_delete(self, identity, catalog, table):
        self._require(identity, catalog, table, "DELETE")

    def check_can_create_table(self, identity, catalog, table):
        self._require(identity, catalog, table, "OWNERSHIP")

    def check_can_drop_table(self, identity, catalog, table):
        self._require(identity, catalog, table, "OWNERSHIP")


class AccessControlManager(AccessControl):
    """security/AccessControlManager: every registered control must allow
    (deny-wins chaining)."""

    def __init__(self):
        self.controls: List[AccessControl] = []

    def add(self, control: AccessControl):
        self.controls.append(control)

    def _all(self, method: str, *args):
        for c in self.controls:
            getattr(c, method)(*args)

    def check_can_execute_query(self, identity):
        self._all("check_can_execute_query", identity)

    def check_can_select(self, identity, catalog, table, columns):
        self._all("check_can_select", identity, catalog, table, columns)

    def check_can_insert(self, identity, catalog, table):
        self._all("check_can_insert", identity, catalog, table)

    def check_can_delete(self, identity, catalog, table):
        self._all("check_can_delete", identity, catalog, table)

    def check_can_create_table(self, identity, catalog, table):
        self._all("check_can_create_table", identity, catalog, table)

    def check_can_drop_table(self, identity, catalog, table):
        self._all("check_can_drop_table", identity, catalog, table)

    def check_can_set_session(self, identity, name):
        self._all("check_can_set_session", identity, name)


class JwtAuthenticator:
    """Bearer-token (JWT) authentication — server/security/jwt analog.

    Validates HS256-signed JWTs with the standard compact serialization
    (header.payload.signature, base64url), checking the signature against
    the shared secret, `exp` expiry, and optional required audience; the
    identity comes from the principal-field claim (default `sub`).  RS256
    public-key verification is out of scope (stdlib-only build)."""

    def __init__(self, secret: str, principal_field: str = "sub",
                 audience: Optional[str] = None):
        self.secret = secret.encode()
        self.principal_field = principal_field
        self.audience = audience

    @staticmethod
    def _b64url_decode(s: str) -> bytes:
        import base64

        pad = "=" * (-len(s) % 4)
        return base64.urlsafe_b64decode(s + pad)

    @staticmethod
    def _b64url_encode(b: bytes) -> str:
        import base64

        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    def sign(self, claims: Dict[str, object]) -> str:
        """Mint a token (testing + internal cluster communication)."""
        import hmac
        import json as _json

        header = self._b64url_encode(
            _json.dumps({"alg": "HS256", "typ": "JWT"}).encode()
        )
        payload = self._b64url_encode(_json.dumps(claims).encode())
        msg = f"{header}.{payload}".encode()
        sig = self._b64url_encode(
            hmac.new(self.secret, msg, hashlib.sha256).digest()
        )
        return f"{header}.{payload}.{sig}"

    def authenticate_token(self, token: str) -> Identity:
        import hmac
        import json as _json
        import time as _time

        try:
            header_s, payload_s, sig_s = token.split(".")
            header = _json.loads(self._b64url_decode(header_s))
            if header.get("alg") != "HS256":
                raise ValueError(f"unsupported alg {header.get('alg')}")
            msg = f"{header_s}.{payload_s}".encode()
            want = hmac.new(self.secret, msg, hashlib.sha256).digest()
            if not hmac.compare_digest(want, self._b64url_decode(sig_s)):
                raise ValueError("bad signature")
            claims = _json.loads(self._b64url_decode(payload_s))
        except AccessDeniedError:
            raise
        except Exception as e:
            raise AccessDeniedError(f"Access Denied: invalid JWT ({e})")
        exp = claims.get("exp")
        if exp is not None and _time.time() > float(exp):
            raise AccessDeniedError("Access Denied: token expired")
        if self.audience is not None:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise AccessDeniedError("Access Denied: wrong audience")
        principal = claims.get(self.principal_field)
        if not principal:
            raise AccessDeniedError(
                f"Access Denied: missing {self.principal_field} claim"
            )
        return Identity(str(principal))


class PasswordAuthenticator:
    """Password-file authentication (plugin/trino-password-authenticators
    PasswordStore): users map to salted sha256 digests; authenticate()
    returns an Identity or raises AccessDeniedError."""

    def __init__(self, users: Dict[str, str], salt: str = "trino-tpu"):
        """users: user -> plaintext password (hashed at construction)."""
        self.salt = salt
        self.digests = {
            u: self._digest(p) for u, p in users.items()
        }

    def _digest(self, password: str) -> str:
        return hashlib.sha256(
            (self.salt + ":" + password).encode()
        ).hexdigest()

    def authenticate(self, user: str, password: str) -> Identity:
        want = self.digests.get(user)
        if want is None or want != self._digest(password):
            raise AccessDeniedError("Access Denied: Invalid credentials")
        return Identity(user)
