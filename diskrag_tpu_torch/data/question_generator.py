"""LLM query augmentation — counterpart of the reference's
`preprocessing/question_generator.py`: prompt an LLM to produce N
semantically-similar questions per FAQ pair (JSON-parsed, retried), plus
an article mode.

Providers: "openai" via httpx REST (the openai SDK is absent here) and
"mock" for offline tests (deterministic template paraphrases).

Copy of `diskrag_tpu/data/question_generator.py` for the PyTorch port, which imports
nothing of the JAX package. httpx is imported inside the LLM call only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Optional

logger = logging.getLogger(__name__)

OPENAI_CHAT_URL = "https://api.openai.com/v1/chat/completions"


@dataclasses.dataclass
class GeneratedQuestion:
    question: str
    chunk_id: int
    chunk_text: str
    source_type: str
    source_id: str
    metadata: dict[str, Any]


_FAQ_PROMPT = """請基於以下問答對，生成 {n} 個語義相似但表達方式不同的問題。
要求：
1. 生成的問題必須與原始問題表達相同的意圖
2. 使用不同的表達方式、詞彙和句式
3. 保持問題的清晰度和可理解性
4. 考慮用戶可能使用的不同問法
5. 每個問題都應該能通過原始答案得到解答

原始問題：{question}
原始答案：{answer}

請以 JSON 格式返回生成的問題列表，格式如下：
{{
    "questions": ["問題1", "問題2"]
}}

只返回 JSON 格式的內容，不要包含其他文字。"""

_ARTICLE_PROMPT = """請基於以下文章段落，生成 {n} 個讀者可能提出、且可由該段落回答的問題。
段落標題：{title}
段落內容：{text}

請以 JSON 格式返回生成的問題列表，格式如下：
{{
    "questions": ["問題1", "問題2"]
}}

只返回 JSON 格式的內容，不要包含其他文字。"""


class QuestionGenerator:
    def __init__(self, config: dict[str, Any] | None = None):
        config = config or {}
        self.config = config
        self.enabled = config.get("enabled", True)
        self.provider = config.get("provider", "openai")
        self.model = config.get("model", "gpt-3.5-turbo")
        self.max_questions = config.get("max_questions", 5)
        self.temperature = config.get("temperature", 0.7)
        self.max_retries = config.get("max_retries", 3)
        self.retry_delay = config.get("retry_delay", 2)
        if self.provider == "openai":
            self.api_key = config.get("api_key") or os.environ.get("OPENAI_API_KEY")
            if not self.api_key:
                raise ValueError(
                    "OPENAI_API_KEY not set (required for the openai provider); "
                    "use provider='mock' for offline runs"
                )
        elif self.provider != "mock":
            raise ValueError(f"unsupported provider: {self.provider}")

    # --- LLM call with retry (reference question_generator.py:63-81) -----
    def _get_completion_with_retry(self, prompt: str) -> Optional[str]:
        if self.provider == "mock":
            return None  # mock path short-circuits in the callers
        import httpx

        for attempt in range(self.max_retries):
            try:
                resp = httpx.post(
                    OPENAI_CHAT_URL,
                    headers={"Authorization": f"Bearer {self.api_key}"},
                    json={
                        "model": self.model,
                        "messages": [{"role": "user", "content": prompt}],
                        "temperature": self.temperature,
                        "max_tokens": 1000,
                    },
                    timeout=60.0,
                )
                resp.raise_for_status()
                return resp.json()["choices"][0]["message"]["content"].strip()
            except Exception as e:  # noqa: BLE001
                if attempt == self.max_retries - 1:
                    logger.error("LLM call failed after %d tries: %s", self.max_retries, e)
                    return None
                logger.warning("LLM call failed, retrying in %ds: %s", self.retry_delay, e)
                time.sleep(self.retry_delay)
        return None

    @staticmethod
    def _parse_questions(response: str) -> list[str]:
        """Parse the JSON questions list, tolerating code fences."""
        text = response.strip()
        if text.startswith("```"):
            text = text.strip("`")
            if text.startswith("json"):
                text = text[4:]
        try:
            data = json.loads(text)
            qs = data.get("questions", [])
            return [q for q in qs if isinstance(q, str) and q.strip()]
        except (ValueError, AttributeError):
            logger.warning("could not parse LLM question JSON")
            return []

    def _mock_questions(self, question: str) -> list[str]:
        templates = [
            "請問{q}",
            "我想知道{q}",
            "{q}的說明",
            "能否告訴我{q}",
            "關於{q}的資訊",
        ]
        base = question.rstrip("?？")
        return [t.format(q=base) for t in templates[: self.max_questions]]

    def generate_similar_questions(
        self,
        original_question: str,
        answer: str,
        source_type: str,
        source_id: str,
        metadata: dict[str, Any],
    ) -> list[GeneratedQuestion]:
        """FAQ mode (reference question_generator.py:83-164)."""
        if not self.enabled:
            return []
        if self.provider == "mock":
            questions = self._mock_questions(original_question)
        else:
            response = self._get_completion_with_retry(
                _FAQ_PROMPT.format(
                    n=self.max_questions, question=original_question, answer=answer
                )
            )
            questions = self._parse_questions(response) if response else []
        return [
            GeneratedQuestion(
                question=q,
                chunk_id=i,
                chunk_text=answer,
                source_type=source_type,
                source_id=source_id,
                metadata=dict(metadata),
            )
            for i, q in enumerate(questions[: self.max_questions])
        ]

    def generate_questions(
        self, title: str, text: str, source_id: str, metadata: dict[str, Any]
    ) -> list[GeneratedQuestion]:
        """Article mode (reference question_generator.py:166-231)."""
        if not self.enabled:
            return []
        if self.provider == "mock":
            questions = self._mock_questions(title)
        else:
            response = self._get_completion_with_retry(
                _ARTICLE_PROMPT.format(n=self.max_questions, title=title, text=text)
            )
            questions = self._parse_questions(response) if response else []
        return [
            GeneratedQuestion(
                question=q,
                chunk_id=i,
                chunk_text=text,
                source_type="article",
                source_id=source_id,
                metadata=dict(metadata),
            )
            for i, q in enumerate(questions[: self.max_questions])
        ]
