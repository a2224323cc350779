"""User authentication (gan_login_gui.py:88-326 parity; a copy of the JAX
package's ``gui/auth.py``, which the port does not import).

- ``users.json`` of {username: sha256(password)} with the same hashing
  (hash_password/validate_login/register_user, :300-326).
- "Remember me": the reference pickles the PLAINTEXT password to
  ``credentials.dat`` (:100-117) — a vulnerability we do not reproduce.
  We store the username plus the password *hash* (enough to skip the login
  screen locally, useless to an attacker who already has users.json).
"""

from __future__ import annotations

import hashlib
import json
import os

USERS_FILE = "users.json"
CREDENTIALS_FILE = "credentials.json"


def hash_password(password: str) -> str:
    return hashlib.sha256(password.encode("utf-8")).hexdigest()


def _load_users(path=USERS_FILE) -> dict:
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    return {}


def _save_users(users: dict, path=USERS_FILE):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(users, f, indent=2)


def validate_login(username: str, password: str, path=USERS_FILE) -> bool:
    users = _load_users(path)
    return users.get(username) == hash_password(password)


def register_user(username: str, password: str, path=USERS_FILE) -> tuple[bool, str]:
    if not username or not password:
        return False, "username and password required"
    users = _load_users(path)
    if username in users:
        return False, "username already exists"
    users[username] = hash_password(password)
    _save_users(users, path)
    return True, "registered"


def save_credentials(username: str, password: str, path=CREDENTIALS_FILE):
    """Remember-me token: username + hash (NOT the plaintext password the
    reference stores)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"username": username,
                   "password_hash": hash_password(password)}, f)


def load_credentials(path=CREDENTIALS_FILE,
                     users_path=USERS_FILE) -> str | None:
    """Returns the remembered username if its stored hash still matches."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            cred = json.load(f)
        users = _load_users(users_path)
        if users.get(cred.get("username")) == cred.get("password_hash"):
            return cred["username"]
    except Exception:
        pass
    return None


def clear_credentials(path=CREDENTIALS_FILE):
    if os.path.exists(path):
        os.remove(path)
