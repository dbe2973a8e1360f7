"""Five-domain evolving user profile.

Parity target: reference ``core/profile.py`` (59 LoC): fixed domains
(preferences, personality_traits, knowledge_domains, interaction_style,
key_experiences), ``update_domain`` only accepts known domains, and
``get_context`` renders title-cased "Domain: content" lines.
``run_consolidation`` fills the domains.
"""

from __future__ import annotations

import time
from typing import Any, Dict

DOMAINS = (
    "preferences",
    "personality_traits",
    "knowledge_domains",
    "interaction_style",
    "key_experiences",
)


class Profile:
    def __init__(self) -> None:
        self.data: Dict[str, str] = {d: "" for d in DOMAINS}
        self.last_updated: float = time.time()

    def update_domain(self, domain: str, content: str) -> bool:
        if domain not in self.data:
            return False
        self.data[domain] = content
        self.last_updated = time.time()
        return True

    def get_context(self) -> str:
        lines = [
            f"{domain.replace('_', ' ').title()}: {content}"
            for domain, content in self.data.items()
            if content
        ]
        return "\n".join(lines) if lines else "No profile data yet."

    def to_dict(self) -> Dict[str, Any]:
        return {"data": dict(self.data), "last_updated": self.last_updated}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Profile":
        p = cls()
        data = d.get("data", d)
        for k, v in data.items():
            if k in p.data and isinstance(v, str):
                p.data[k] = v
        p.last_updated = d.get("last_updated", time.time())
        return p
