"""Five-domain evolving user profile.

Parity target: reference ``core/profile.py`` (59 LoC): fixed domains
(preferences, personality_traits, knowledge_domains, interaction_style,
key_experiences), and ``get_context`` renders title-cased
"Domain: content" lines. Profile updates come with ``run_consolidation``
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import time
from typing import Dict

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

    def get_context(self) -> str:
        lines = [
            f"{domain.replace('_', ' ').title()}: {content}"
            for domain, content in self.data.items()
            if content
        ]
        return "\n".join(lines) if lines else "No profile data yet."
